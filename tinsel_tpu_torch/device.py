"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a visible GPU raises:
    the port never falls back to the CPU on its own; pass ``device="cpu"``
    to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tinsel_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU"
            )
        # Full f32 matmuls and convolutions on the card: TF32 keeps ~3
        # decimal digits, and the port is held to f32 parity with the JAX
        # reference (camera matrices, splat, NLM).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev

"""Failure detection and recovery for the progressive render loop; the
port of ``tinsel_tpu/parallel/failure.py``.

- **Corruption**: after each chunk, one all-finite reduction on the device
  and one host read check the buffer (the loop's only sync). A non-finite
  chunk (a pathological sample, or a transient device fault) would poison
  the running sum forever, so the guard rolls back to the last verified
  buffer and renders the chunk again under a reseeded source: the retry
  draws under ``(_RETRY_SALT + attempt, ...)``, the JAX package's
  ``fold_in(key, _RETRY_SALT + attempt)``. With a source whose draws
  follow the path (``core.sampling.PathUniforms``) that is another,
  reproducible sample set.
- **Device errors**: a chunk that raises ``torch.AcceleratorError`` (what
  PyTorch raises for an error the CUDA runtime reports) is retried with
  exponential backoff from the rolled-back buffer. Nothing else is
  retried: a plain ``RuntimeError``, a kernel's build error or a launch the
  wrapper refused propagates at once.
- **Salvage**: when the retries run out, the last verified buffer is
  written through the checkpoint format, so that ``-resume`` loses at most
  one chunk, and ``RenderFailure`` is raised.
"""

from __future__ import annotations

import time

import torch

from ..core.sampling import Prefixed
from .checkpoint import save_checkpoint


class RenderFailure(RuntimeError):
    """Raised when a chunk cannot be recovered within the retry budget."""


def chunk_health(accum) -> bool:
    """True iff the accumulation buffer is wholly finite (one reduction on
    the buffer's device, one host read)."""
    return bool(torch.isfinite(accum).all())


class ChunkGuard:
    """Detect / roll back / retry around an accumulate step.

    Usage::

        guard = ChunkGuard(salvage_path="render.ckpt", seed=seed)
        accum = guard.run(step, accum, flat, cam, source, pass_idx, spp_done=s)

    ``run`` returns a verified buffer; the caller never sees a poisoned one.
    """

    # a prefix of its own for retries, so that a retried chunk can never
    # draw a later pass's samples
    _RETRY_SALT = 0x5AFE_0000

    def __init__(self, *, retries: int = 2, backoff_s: float = 1.0,
                 salvage_path: str | None = None, seed: int = 0):
        self.retries = retries
        self.backoff_s = backoff_s
        self.salvage_path = salvage_path
        self.seed = seed
        self.events: list[dict] = []  # audit log: one entry per anomaly

    def _log(self, kind: str, pass_idx: int, attempt: int, detail: str = ""):
        self.events.append(
            {"kind": kind, "pass": int(pass_idx), "attempt": attempt,
             "detail": detail}
        )
        print(f"[guard] {kind} on pass {pass_idx} (attempt {attempt})"
              + (f": {detail}" if detail else ""), flush=True)

    def _salvage(self, accum, spp_done: int):
        if self.salvage_path is None:
            return
        try:
            save_checkpoint(self.salvage_path, accum, spp_done, self.seed,
                            meta={"salvaged": True})
            print(f"[guard] salvaged verified state ({spp_done} spp) -> "
                  f"{self.salvage_path}", flush=True)
        except (OSError, torch.AcceleratorError) as e:  # disk full, device gone
            print(f"[guard] salvage failed: {e}", flush=True)

    def run(self, step_fn, accum, scene, cam, source, pass_idx,
            *, spp_done: int = 0):
        """One guarded chunk: returns the new verified accumulation buffer."""
        last_good = accum
        for attempt in range(self.retries + 1):
            src = source if attempt == 0 else Prefixed(source, self._RETRY_SALT + attempt)
            try:
                out = step_fn(last_good, scene, cam, src, pass_idx)
                if chunk_health(out):
                    return out
                self._log("corrupt-chunk", pass_idx, attempt,
                          "non-finite accumulation; rolled back + reseeded")
            except torch.AcceleratorError as e:
                self._log("device-error", pass_idx, attempt,
                          str(e).splitlines()[0][:120])
                time.sleep(self.backoff_s * (2 ** attempt))
        self._salvage(last_good, spp_done)
        raise RenderFailure(
            f"pass {pass_idx} failed after {self.retries + 1} attempts; "
            f"last verified state ({spp_done} spp)"
            + (f" salvaged to {self.salvage_path}" if self.salvage_path
               else " not salvaged (no checkpoint path)")
        )

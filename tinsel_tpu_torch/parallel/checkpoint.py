"""Checkpoint / resume of a progressive render; the port's copy of
``tinsel_tpu/parallel/checkpoint.py``.

The state of a render is (accumulation RGBA buffer, spp done, seed). The
file is the JAX package's ``.npz`` schema (``accum`` f32, ``spp_done`` and
``seed`` int64, ``meta`` a JSON string), so a checkpoint written by either
package resumes in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def save_checkpoint(path: str, accum, spp_done: int, seed: int, meta: dict | None = None):
    """``accum``: a host array or a tensor on any device (copied to the
    host once). Written to a temporary file, then renamed over ``path``."""
    if isinstance(accum, torch.Tensor):
        accum = accum.detach().cpu().numpy()
    tmp = path + ".tmp.npz"  # np.savez appends .npz to a name without it
    np.savez_compressed(
        tmp,
        accum=np.asarray(accum, np.float32),
        spp_done=np.int64(spp_done),
        seed=np.int64(seed),
        meta=json.dumps(meta or {}),
    )
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """Returns (accum ndarray, spp_done, seed, meta dict)."""
    with np.load(path, allow_pickle=False) as z:
        return (
            z["accum"],
            int(z["spp_done"]),
            int(z["seed"]),
            json.loads(str(z["meta"])),
        )

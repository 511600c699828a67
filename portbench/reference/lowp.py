"""The control: the reference computed in bfloat16, the nearest precision
below the float32 that the port states. While ``Bf16`` is active every
float32 result of every aten operation (forward and backward) is rounded
to bfloat16, as a computation in bfloat16 would store it; the draws are
inputs, and ``quiet`` pauses the rounding around them. Operations that only
move or select values (``_MOVES``) leave them as they are."""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

_DRAWS = {"uniform_", "random_", "normal_", "bernoulli_", "exponential_", "randint",
          "rand", "randn", "randperm"}
# operations that move, select or lay out values without computing new
# ones: their results are values that were made (or loaded) before, and
# the scene's tables keep integer bits in float32 rows (the BVH's child and
# block offsets), which rounding would destroy
_MOVES = {"_to_copy", "copy_", "clone", "cat", "stack", "index", "index_select", "gather",
          "where", "masked_fill", "masked_fill_", "constant_pad_nd", "repeat",
          "repeat_interleave", "flip", "roll", "index_put_", "index_put", "scatter",
          "scatter_", "lift_fresh", "lift_fresh_copy", "_unsafe_view", "unfold",
          "clamp", "clamp_min", "clamp_max", "minimum", "maximum", "amax", "amin", "max",
          "min", "sort", "topk", "argmax", "argmin", "full", "zeros", "ones", "empty",
          "fill_", "zero_", "zeros_like", "ones_like", "full_like", "empty_like", "scalar_tensor",
          "arange", "_local_scalar_dense", "detach", "alias", "set_", "contiguous"}


def _round(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    return x


class Bf16(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.paused = 0

    @contextlib.contextmanager
    def quiet(self):
        self.paused += 1
        try:
            yield
        finally:
            self.paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if self.paused or name in _DRAWS or name in _MOVES:
            return out
        if name.endswith("_") or "out" in kwargs:
            # an in-place or out= result: round it where it lies
            for t in ([kwargs["out"]] if "out" in kwargs else [args[0]]):
                if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                    t.copy_(t.to(torch.bfloat16))
            return out
        if func._schema.returns and any(r.alias_info is not None for r in func._schema.returns):
            return out  # a view: its base was rounded where it was made
        return tree_map(_round, out)

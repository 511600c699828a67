"""tinsel_tpu_torch: the PyTorch/CUDA port of the tinsel_tpu path tracer.

The package mirrors ``tinsel_tpu``'s module layout (``render/trace.py`` here
is the port of ``tinsel_tpu/render/trace.py``) and is written for an NVIDIA
Hopper card: plain tensor code is PyTorch, and the NLM denoiser kernels are
hand-written CUDA (``csrc/nlm.cu``, built at first use by ``ops/_build.py``).

It imports neither JAX nor ``tinsel_tpu``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; without a GPU they raise.
"""

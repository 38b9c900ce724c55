"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package imports nothing of
it and nothing of JAX.  Module names mirror ``repro``'s.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; every Pallas TPU
kernel on a ported path is a hand-written Hopper kernel under ``csrc/``,
built with ``nvcc`` at first use (``kernels/_build.py``).
"""

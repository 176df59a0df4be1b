"""mpmc_tpu_torch — the PyTorch and CUDA port of ``mpmc_tpu`` for NVIDIA
Hopper (H100).

It mirrors the JAX package's sub-packages (``io``, ``text``, ``image``,
``ops``, ``models``, ``train``, ``cli``) and imports nothing of it, nor of
JAX.  Its kernels are CUDA C++ sources under ``csrc/``, built with ``nvcc``
at first use (``ops/build.py``); each has a plain PyTorch version beside it
that CPU tensors run.
"""

"""PyTorch + CUDA port of the ``repro`` package for an NVIDIA H100.

Modules mirror ``src/repro/``; the kernels are CUDA C++ for ``sm_90a`` under
``kernels/csrc/``, built with ``nvcc`` at first use.  Nothing here imports
JAX or the JAX package.
"""

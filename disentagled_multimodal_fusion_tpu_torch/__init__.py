"""PyTorch / CUDA port of ``disentagled_multimodal_fusion_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference the port is held against
(``tests/test_torch_*.py``). This package imports torch, numpy and scipy
only, never JAX nor the JAX package.

Every entry point takes ``device=None``, which means the CUDA card: without
one it raises. Pass ``device="cpu"`` (or ``--device cpu``) to run the plain
PyTorch versions of the kernels on the CPU.

Ported so far: the serving path (``runners/serve.py``) with its evidential
head kernel (``csrc/evidential_head.cu``). Training comes next.
"""

"""PyTorch / CUDA port of ``disentagled_multimodal_fusion_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference the port is held against
(``tests/test_torch_*.py``). This package imports torch, numpy and scipy
only, never JAX nor the JAX package.

Every entry point takes ``device=None``, which means the CUDA card: without
one it raises. Pass ``device="cpu"`` (or ``--device cpu``) to run the plain
PyTorch versions of the kernels on the CPU.

Ported: serving (``runners/serve.py``, the daemon, the HTTP front and
``torch.export`` artifacts), the three sweep runners (``runners/run.py``,
``run_synthetic.py``, ``run_luma.py``) with their engines, ``--dtype
bfloat16`` and ``evaluate.py``, and both TPU kernels as CUDA kernels
(``csrc/evidential_head.cu`` with its bf16 build, ``csrc/probe_epoch.cu``),
the mesh over ``torch.distributed`` ranks (``parallel/``: its ``data``
axis, ``--data-parallel``, and its ``model`` axis, ``--model-parallel``,
whose ranks hold only their blocks of the parameters it cuts through a
fit) and ``runners/sweep_parallel.py``, and the unfused heads'
training (``fused_heads=False``). Every module, runner flag and TPU kernel
of the JAX package has its counterpart here.
"""

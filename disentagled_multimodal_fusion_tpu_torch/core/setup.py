"""Process-level torch configuration and device resolution.

Counterpart of ``disentagled_multimodal_fusion_tpu/core/setup.py``. The JAX
package pins f32-accurate matmuls for parity with the reference's numerics
(its ``core/setup.py:29-46``); here that means TF32 off for both cuBLAS
matmuls and cuDNN convolutions, and bf16 products (``--dtype bfloat16``)
summed in f32: cuBLAS's default may reduce a bf16 GEMM's partial sums in
bf16, which neither XLA nor the JAX package does. The compilation cache
and the multi-host init of the JAX side have no counterpart.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def configure() -> None:
    """Keep float32 matmuls in full float32 on the card (no TF32), and sum
    bf16 products in f32 (no bf16 reduced-precision reduction)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none; the CPU
    is used only when asked for by name."""
    configure()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (or --device cpu) "
                "to run the plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)

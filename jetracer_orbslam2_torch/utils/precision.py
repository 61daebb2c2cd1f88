"""Float32 precision settings (counterpart of the JAX package's
`utils/precision.py` and of its tests' `jax_default_matmul_precision`).

The JAX package forces exact f32 on patch selection, orientation, BRIEF and
all estimation math, because rounded operands flip BRIEF bits and move poses
by centimetres.  On a CUDA device the equivalent hazards are TF32 tensor-core
matmuls and cuDNN's TF32 convolutions; every entry point calls
`set_exact_f32()` so neither can be switched on behind the port's back.
"""

from __future__ import annotations

import torch


def set_exact_f32() -> None:
    """Disable TF32 everywhere: f32 products are computed in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

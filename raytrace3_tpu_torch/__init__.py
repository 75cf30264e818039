"""raytrace3_tpu_torch — the PyTorch/CUDA port of raytrace3_tpu's SPPM renderer.

The JAX package ``raytrace3_tpu`` beside this one is the reference; every
module here names its counterpart there.  This package imports ``torch`` and
never ``jax``.  Its kernels are hand-written CUDA C++ for Hopper
(``csrc/``), built with ``nvcc`` at first use; each has a plain PyTorch twin
that the wrappers take for tensors on the CPU.  Its entry points run on the
card unless the caller passes ``device="cpu"`` (``core/device.py``).

Every geometry and table contraction runs in true fp32: TF32 is switched off
for matmul and cuDNN at import (on the TPU, the bf16 matmul default made
every render 1.27x too bright; TF32 is the GPU form of the same trap).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

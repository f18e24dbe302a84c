"""sesr_tpu_torch — the PyTorch/CUDA port of sesr_tpu for NVIDIA Hopper.

A second package beside the JAX one: it imports torch and numpy, never jax
and nothing of ``sesr_tpu``. Public functions keep the JAX package's NHWC
layout. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on a CUDA tensor the three fused whole-network kernels
(``csrc/sesr_net.cu``, ``csrc/sesr_corrected.cu``) run, on a CPU tensor
their plain PyTorch version (``quant/integer.py``).
"""

from sesr_tpu_torch.config import DEFAULT_HW, TASKS, HardwareConfig

__version__ = "0.1.0"

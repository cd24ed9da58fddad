"""repro_torch: the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

Same module layout as the JAX package (``configs``, ``core``, ``kernels``,
``models``, ``data``), written in PyTorch idiom.  The attention and the
staged LayerNorm run through CUDA kernels written by hand for ``sm_90a``
(``csrc/``, built with ``nvcc`` at first use into ``build/`` and bound with
``ctypes``); on a CPU tensor each kernel wrapper takes its plain PyTorch
version instead, which is what the CPU tests hold against the JAX package.

This package imports neither ``jax`` nor anything of ``repro``.
"""

import torch

from repro_torch.device import resolve_device  # noqa: F401

# The float path must compute full float32 products, as the JAX reference
# does, so TF32 is off for matmuls and cuDNN wherever the port is imported.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

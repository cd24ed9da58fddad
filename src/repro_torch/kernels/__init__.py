"""Hand-written CUDA kernels for Hopper, one subpackage per TPU kernel.

Each ships ``ref.py`` (the plain PyTorch version) and ``ops.py`` (the
wrapper): on a CPU tensor the wrapper runs the plain version, on a CUDA
tensor it launches the kernel (sources in ``repro_torch/csrc``, built by
``kernels.build``) or raises.  Every launch adds one to
``LAUNCHES[<kernel>]``; nothing else touches the counts but a caller that
resets them.
"""

import collections

LAUNCHES: collections.Counter = collections.Counter()

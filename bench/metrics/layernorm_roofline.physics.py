"""The LayerNorm kernel's share of its roofline in the traced stretch, in
percent: its calls' summed bounds over its summed device time."""

from bench.metrics import _roofline


def read(run):
    return _roofline.share(run, "layernorm", _roofline.LAYERNORM_KERNELS,
                           _roofline.layernorm_bound_s)

"""Hand-written CUDA kernels for Hopper, one subpackage per TPU kernel.

Each ships ``ref.py`` (the plain PyTorch version) and ``ops.py`` (the
wrapper): on a CPU tensor the wrapper runs the plain version, on a ``meta``
tensor too (shapes only: what the dry run counts), on a CUDA tensor it
launches the kernel (sources in ``repro_torch/csrc``, built by
``kernels.build``) or raises.  Every launch adds one to
``LAUNCHES[<kernel>]``; nothing else touches the counts but a caller that
resets them.  Where a wrapper launches or runs its plain version, it
reports the call's work (``roofline.kernel_costs``) to an active
``roofline.op_counter.OpCounter``; with none active that is one check.

A kernel writes its output through a raw pointer, so autograd cannot see
through it.  ``flash_attention``, ``layernorm`` and ``ssd_scan`` carry
gradients through a ``torch.autograd.Function`` (their ``autograd.py``: the
kernel forward, a backward in torch ops).  ``lut_softmax`` and ``qmatmul``
have no backward yet, and on the card they raise under grad
(:func:`require_no_grad`) rather than hand back an output that silently
drops its inputs' gradient.  For the same reason every wrapper refuses a
``DTensor`` (:func:`refuse_dtensor`): its pointer would be one shard's.
"""

import collections

import torch

LAUNCHES: collections.Counter = collections.Counter()

#: devices on which a wrapper runs its plain version
PLAIN_DEVICES = ("cpu", "meta")

# the ROADMAP item (queue 1) that ports each kernel's backward
BACKWARD_ITEM = {
    "lut_softmax": "item 9 (the other datapaths)",
    "qmatmul": "item 9 (the other datapaths)",
}


def require_no_grad(kernel: str, *tensors) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires grad: the
    kernel ``kernel`` has no backward, so its output would silently drop
    the gradient of its inputs."""
    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"the {kernel} kernel has no backward yet (ROADMAP queue 1, "
            f"{BACKWARD_ITEM[kernel]}); call it under torch.no_grad() or on "
            "tensors that do not require grad"
        )


def refuse_dtensor(kernel: str, *tensors) -> None:
    """Raise when any of ``tensors`` is a ``DTensor``: the kernel ``kernel``
    reads raw pointers, which on a DTensor address one shard.  Gather it to
    a plain tensor first (``full_tensor()``), as the sharded train step
    does."""
    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"the {kernel} kernel takes plain tensors, not a DTensor: its pointer "
                        "would address one shard; gather it first (DTensor.full_tensor())")

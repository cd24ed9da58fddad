"""Count the work of an eager step: the port's counterpart of the
reference's ``roofline/hlo_parser.py``.

The port has no HLO.  What it runs is the eager sequence of aten ops and
hand-written kernel launches, so :class:`OpCounter` (a
``TorchDispatchMode``) counts those as they run, on ``meta`` tensors (the
dry run: shapes only, nothing computed or allocated) and on ``cuda``
tensors alike:

* **FLOPs** of matmul-like ops (mm, bmm, addmm, baddbmm, convolutions,
  SDPA and their backwards), from ``torch.utils.flop_counter``'s registry
  of formulas, recorded by the type of the op's inputs (float64 counts as
  float64, never at a float32 peak).  Elementwise ops count no FLOPs, as
  the reference's parser counts only dots and convolutions.
* **Bytes**: each op's tensor inputs read once (a broadcast view at most
  its storage) and its outputs written once; ``copy_`` reads only its
  source.  View and metadata ops (and allocations, ``arange``) count
  nothing, as the reference's ``_MEM_OPS_SKIP``.
* **The attention volume**: ops under the ``attnvol`` tag (``with
  op_counter.attnvol:``, at the port's counterparts of the reference's
  ``jax.named_scope("attnvol")``) and, under autograd, their backward are
  counted apart as well, so the analysis can re-price them as the fused
  kernel.  With no counter active the tag is one module-level check.
* **Kernel calls.**  A kernel launch goes through its extension, not the
  dispatcher, so a wrapper that adds to ``kernels.LAUNCHES`` also reports
  the call (:meth:`OpCounter.launch`), priced by
  ``roofline.kernel_costs``.  A wrapper that runs its plain version (on the
  CPU or on ``meta``) reports the call too (:meth:`OpCounter.plain_call`):
  its ops are counted as they run, and apart, so the analysis can put the
  kernel's cost in their place.
* **Temp bytes**: the peak of the bytes held by live op outputs.

No trip counts are needed: the reference's parser exists because XLA's
cost analysis visits a scan body once, but eager PyTorch dispatches every
layer's ops itself, so each one is counted as often as it runs.
Collective bytes are not dispatched ops here; ``launch.dryrun`` counts
them from what the sharded step calls.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.kernel_costs import KernelCost

#: the innermost active counter, or None
ACTIVE: OpCounter | None = None

_ATTN_KEY = "repro_torch.attnvol"

#: ops that move no bytes: allocations, constants and metadata (views are
#: skipped by ``func.is_view``)
_SKIP = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "arange",
    "scalar_tensor", "lift_fresh", "_unsafe_view", "alias", "detach", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size", "_local_scalar_dense",
    "resize_", "set_",
})


@dataclasses.dataclass
class Tally:
    """FLOPs by input type and bytes of a set of ops."""

    flops: dict[str, float] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(float))
    bytes: float = 0.0

    @property
    def total_flops(self) -> float:
        return math.fsum(self.flops.values())

    def add(self, flops: dict[str, float], nbytes: float) -> None:
        for t, f in flops.items():
            self.flops[t] += f
        self.bytes += nbytes


@dataclasses.dataclass(frozen=True)
class KernelCall:
    cost: KernelCost
    launched: bool  # True: the kernel ran; False: its plain version did


@dataclasses.dataclass
class Count:
    """What one counted run did."""

    ops: Tally  # every dispatched op
    attn: Tally  # the attnvol-tagged subset (forward and backward)
    plain: dict[str, Tally]  # ops inside each kernel's plain version
    attn_in_plain: Tally  # attnvol ops inside a plain version
    calls: list[KernelCall]
    peak_live_bytes: int
    n_ops: int

    @property
    def launches(self) -> list[KernelCost]:
        return [c.cost for c in self.calls if c.launched]

    @property
    def flops(self) -> dict[str, float]:
        """FLOPs by type: the dispatched ops' and the launched kernels'."""
        out = collections.defaultdict(float, self.ops.flops)
        for cost in self.launches:
            for t, f in cost.flops.items():
                out[t] += f
        return dict(out)

    @property
    def total_flops(self) -> float:
        return math.fsum(self.flops.values())

    @property
    def hbm_bytes(self) -> float:
        return self.ops.bytes + math.fsum(c.bytes for c in self.launches)

    @property
    def attn_flops(self) -> float:
        return self.attn.total_flops

    @property
    def attn_hbm_bytes(self) -> float:
        return self.attn.bytes


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    """Bytes a read of ``t`` moves: its elements, at most its storage's (a
    broadcast view reads its storage once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):  # a tensor without storage
        return n


def _flop_type(args) -> str:
    """The type of a matmul-like op's matrices: the first tensor argument
    of two or more dimensions (a bias comes first in addmm)."""
    ts = list(_tensors(args))
    mat = next((t for t in ts if t.ndim >= 2), ts[0] if ts else None)
    return "float32" if mat is None else str(mat.dtype).removeprefix("torch.")


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: ...`` counts every op the block runs;
    :meth:`result` gives the :class:`Count`.  Counters nest; the innermost
    takes the kernels' reports."""

    def __init__(self):
        super().__init__()
        self._ops, self._attn, self._attn_in_plain = Tally(), Tally(), Tally()
        self._plain: dict[str, Tally] = collections.defaultdict(Tally)
        self._calls: list[KernelCall] = []
        self._attn_depth = 0
        self._plain_kernel: str | None = None
        self._attn_outputs: list[torch.Tensor] = []
        self._live = 0
        self._peak = 0
        self._n_ops = 0
        self._outer: OpCounter | None = None

    # -- activation ----------------------------------------------------------

    def __enter__(self):
        global ACTIVE
        self._outer, ACTIVE = ACTIVE, self
        return super().__enter__()

    def __exit__(self, *exc):
        global ACTIVE
        ACTIVE = self._outer
        return super().__exit__(*exc)

    # -- reports from the tag and the kernel wrappers -------------------------

    def _enter_attn(self) -> None:
        self._attn_depth += 1

    def _exit_attn(self) -> None:
        self._attn_depth -= 1
        if self._attn_depth == 0:
            # tag the autograd nodes made under the tag: their backward ops
            # are attention volume too
            for t in self._attn_outputs:
                if t.grad_fn is not None:
                    t.grad_fn.metadata[_ATTN_KEY] = True
            self._attn_outputs.clear()

    def launch(self, cost: KernelCost) -> None:
        """A wrapper launched its kernel: ``cost`` is the call's work."""
        self._calls.append(KernelCall(cost, True))

    @contextlib.contextmanager
    def plain_call(self, cost: KernelCost):
        """A wrapper runs its plain version in the block: ``cost`` is what
        the kernel would have done; the block's ops are tallied apart."""
        self._calls.append(KernelCall(cost, False))
        outer, self._plain_kernel = self._plain_kernel, self._plain_kernel or cost.kernel
        try:
            yield
        finally:
            self._plain_kernel = outer

    # -- the dispatch ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.is_view or name in _SKIP:
            return out
        self._n_ops += 1
        flops = {}
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            flops = {_flop_type(args): float(formula(*args, **kwargs, out_val=out))}
        inputs = {id(t): t for t in _tensors((args, kwargs))}
        outputs = list(_tensors(out))
        if name == "copy_":  # writes its destination, reads its source
            inputs.pop(id(args[0]), None)
        nbytes = float(sum(_nbytes(t) for t in inputs.values())
                       + sum(_nbytes(t) for t in outputs))
        self._ops.add(flops, nbytes)
        in_attn = self._attn_depth > 0
        if not in_attn and not torch.is_grad_enabled():
            node = torch._C._current_autograd_node()  # a backward op: its node's tag
            in_attn = node is not None and node.metadata.get(_ATTN_KEY, False)
        if in_attn:
            self._attn.add(flops, nbytes)
            if self._attn_depth > 0 and torch.is_grad_enabled():
                self._attn_outputs.extend(outputs)
        if self._plain_kernel is not None:
            self._plain[self._plain_kernel].add(flops, nbytes)
            if in_attn:
                self._attn_in_plain.add(flops, nbytes)
        self._track_live(inputs.values(), outputs)
        return out

    def _track_live(self, inputs, outputs) -> None:
        """Add each output that owns a new storage to the live bytes until
        the tensor is freed."""
        try:
            held = {t.untyped_storage()._cdata for t in inputs}
        except (RuntimeError, NotImplementedError):
            return
        for t in outputs:
            storage = t.untyped_storage()
            if storage._cdata in held:
                continue  # in place, or a view of an input
            n = storage.nbytes()
            self._live += n
            self._peak = max(self._peak, self._live)
            weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self._live -= n

    def result(self) -> Count:
        return Count(ops=self._ops, attn=self._attn, plain=dict(self._plain),
                     attn_in_plain=self._attn_in_plain, calls=list(self._calls),
                     peak_live_bytes=self._peak, n_ops=self._n_ops)


class _AttnVol:
    """``with attnvol:`` tags the ops of the block (and their backward) as
    attention volume for an active counter; with none, it checks one
    module-level name and makes nothing."""

    __slots__ = ()

    def __enter__(self):
        if ACTIVE is not None:
            ACTIVE._enter_attn()

    def __exit__(self, *exc):
        if ACTIVE is not None:
            ACTIVE._exit_attn()


attnvol = _AttnVol()


def count(fn, *args, **kwargs) -> tuple[object, Count]:
    """(``fn(*args, **kwargs)``, its :class:`Count`)."""
    with OpCounter() as c:
        out = fn(*args, **kwargs)
    return out, c.result()

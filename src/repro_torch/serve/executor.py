"""Execution layer of the serving stack: *device work only, no policy*
(port of ``repro.serve.executor``).

:class:`ModelExecutor` owns everything that touches the device: the
precision plan applied to the params, the ``CacheManager`` with the device
caches it writes in place, and the slot table (execution state: write
positions, carry tokens, pending teacher-forced tails).  It consumes an
explicit ``ScheduleDecision`` and applies it: reset preempted slots,
activate admissions, run one fixed-shape ``(max_batch, bucket)`` prefill
dispatch per bucket group, drain cache-extend windows, verify speculative
drafts, run ``decode_steps`` decode steps in one dispatch, retire finished
slots.  Every choice was made by the scheduler.

The program discipline is the reference's, counted the same way: at most
``len(prefill_buckets)`` prefill shapes (``prefill_compiles``), one decode
shape (``decode_compiles``) and, where the datapath has it, one
cache-extending prefill shape ``(max_batch, extend_width)``
(``extend_compiles``).  The reference's decode scan is one compiled
program; here it is a Python loop over ``lm.forward`` whose tokens,
positions, active, budget and eos masks stay on the device, and whose
results cross to the host once per dispatch.  The caches are the
executor's own: every forward writes into them in place
(``lm.forward(..., in_place=True)``), never into a copy.

One predicate, ``prefill_on_kernel``, maps the reference's ``use_pallas``
to the device: on the CPU the prefill attends through the plain version
(the reference's jnp rows), on CUDA through the hand-written kernel (its
"Pallas streaming attention" row, README's datapath capability matrix).
``bit_exact`` (the decode path's forward is bitwise the prefill path's)
and ``cache_extend`` (the extend program's window attend is the prefill's
math) both need the plain version, so on the card both are False and the
features that need them (prefill-skip, chunking, preemption resume,
speculative decoding) report themselves disabled, as the reference's
Pallas row does.

The async loop (``ServeConfig.async_loop``) splits each step into a
dispatch and a collect one step apart, and keeps the decode carry (token,
position, active, budget) on the device between dispatches: a pure decode
dispatch makes no synchronising call, the carry merge is a ``torch.where``
over a mask copied up, and the results come down through a non-blocking
copy into pinned memory that ``collect`` waits for.

``shard_decode`` is the reference's mesh-sharded decode (its host mesh:
``data`` every rank, ``model`` 1) in torch's SPMD idiom: one engine whose
slots split over ``data``.  The params and the cache pools are placed as
DTensors over the process group's host mesh under the reference's
shardings; each rank computes with whole parameters and with its cache
shards (the dense slabs' rows and the page table's rows of its slots, the
paged pools whole).  Rank 0 owns the engine (the API, the scheduler, the
host cache manager); every device program (a :func:`_program` method)
first broadcasts its host operands (tokens, positions, masks, knobs,
forced tokens, the page table and the page copies), and the other ranks
run them in :meth:`ModelExecutor.serve_worker` until rank 0 closes
(:class:`SlotShard`).  A program indexed by slot (the decode steps, the
extend window, the draft's proposals) runs on this rank's contiguous run
of ``max_batch / world`` slots, cut as ``rules.batch_spec`` cuts the
batch, and its per-slot outputs are all-gathered in slot order; a program
indexed by admission row (a bucket prefill, a draft resync) runs
replicated, every rank computing every row and keeping the rows of its
slots.  The paged pools stay one pool: every rank writes every prefill's
pages, and after a split program each rank's written rows are copied to
the others (``kv_cache.share_written_rows``), so a prefix hit, a fork, a
copy-on-write copy or a spill on any rank reads what any rank wrote.  Every
rank draws the whole batch's sampling keys from the same seeded generator
and uses its own rows, so rank 0's streams are the one-rank engine's.  When
the world does not divide ``max_batch``, every rank runs every slot (the
reference's ``batch_spec`` fallback).  Over one rank it is a semantic
no-op.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import trace
from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.core import precision as precision_lib
from repro_torch.device import resolve_device, upload
from repro_torch.models import lm
from repro_torch.models import params as params_lib
from repro_torch.serve import kv_cache
from repro_torch.serve.phases import NULL_TRACER
from repro_torch.serve.sampling import draw_keys, sample_tokens
from repro_torch.serve.scheduler import (
    MODE_FORK,
    MODE_SKIP,
    Admission,
    ExecutorCaps,
    Request,
    ScheduleDecision,
    Slot,
    encode_sampling,
)


def _salted_seed(seed: int, replica: int) -> int:
    """The generator seed of replica ``replica``: distinct (seed, replica)
    pairs give distinct unseeded streams (the reference folds the replica
    into its key the same way)."""
    if not replica:
        return seed
    return (seed * 0x9E3779B1 + replica * 0x85EBCA77 + 1) % (1 << 63)


def _knobs(knobs, positions, dev: torch.device) -> dict:
    """``sample_tokens``' keyword tensors from per-row ``encode_sampling``
    tuples and the processed tokens' positions, uploaded."""
    k = np.array(knobs, np.float64).reshape(-1, 4)
    return dict(temperature=upload(k[:, 0].astype(np.float32), dev),
                top_k=upload(k[:, 1].astype(np.int32), dev),
                top_p=upload(k[:, 2].astype(np.float32), dev),
                seed=upload(k[:, 3].astype(np.int32), dev),
                positions=upload(np.asarray(positions, np.int32), dev))


@dataclasses.dataclass
class SlotShard:
    """This rank's place in a ``shard_decode`` engine of ``world`` ranks
    (module docstring): the slots [lo, hi) it computes (all of them when
    ``split`` is False: the world does not divide ``max_batch``), and the
    process group over which rank 0 sends its programs and the ranks
    gather their per-slot outputs."""

    world: int
    rank: int
    lo: int
    hi: int
    split: bool
    group: Any = None
    #: rank 0 has ended the workers' loops: no program runs any more
    closed: bool = False

    @property
    def controls(self) -> bool:
        """Rank 0 of several: the rank that sends every program."""
        return self.world > 1 and self.rank == 0

    def send(self, message) -> None:
        dist.broadcast_object_list([message], src=0, group=self.group)

    def recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank (= slot)
        order; ``t`` itself when every rank holds every slot."""
        if not self.split:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)

    def local_slots(self, slots) -> np.ndarray:
        """``slots`` (host) as indices into this rank's rows; a slot of
        another rank, and the pad sentinel, become this rank's sentinel."""
        slots = np.asarray(slots, np.int64)
        mine = (slots >= self.lo) & (slots < self.hi)
        return np.where(mine, slots - self.lo, self.hi - self.lo)


def _program(fn):
    """A device program: its arguments are host operands, and on the rank
    that controls a ``shard_decode`` engine they go to every worker rank
    before it runs, so every rank runs it (``ModelExecutor.serve_worker``)."""

    @functools.wraps(fn)
    def run(self, *args):
        if self.shard is not None and self.shard.controls:
            if self.shard.closed:
                raise RuntimeError("the shard_decode engine is closed: its workers have left")
            self.shard.send((fn.__name__, args))
        return fn(self, *args)

    return run


@dataclasses.dataclass
class StepOutput:
    """What one executed decision produced, for the API layer to route:
    ``tokens`` are (uid, token, index-in-generated) in emission order,
    ``finished``/``preempted`` the requests that left their slots."""

    stats: dict
    tokens: list[tuple[int, int, int]] = dataclasses.field(default_factory=list)
    finished: list[Request] = dataclasses.field(default_factory=list)
    preempted: list[Request] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class InflightStep:
    """A dispatched-but-uncollected step (the async loop's double-buffer
    token).  ``out`` holds what the prefill, extend and speculative
    dispatches produced (they sample on the host); the decode results are
    still on their way to the host until :meth:`ModelExecutor.collect`
    waits for them.  ``snapshot`` / ``admit_seqs`` pin each decode slot's
    request and admission stamp at dispatch, so a slot cancelled or turned
    over (even back to the same request) before collect has its tokens
    dropped."""

    out: StepOutput
    decision: ScheduleDecision
    #: slots the decode dispatch covered (sorted), () = no decode ran
    decode_set: tuple[int, ...] = ()
    #: the decode dispatch's results packed in one int32 device tensor:
    #: rows [0, T) tokens, [T, 2T) emit masks, then the final token,
    #: position, active mask and budget; None when no decode ran
    dev: Any = None
    #: on a card: (the pinned host tensor the results are copied into
    #: without blocking, the event recorded after the copy)
    host: Any = None
    snapshot: dict[int, Request] = dataclasses.field(default_factory=dict)
    admit_seqs: dict[int, int] = dataclasses.field(default_factory=dict)
    #: monotone dispatch stamp: collect clears a slot's in-flight mark only
    #: when no newer dispatch re-marked it
    seq: int = 0
    #: the decode dispatch's span (0 untraced): its collect names it as cause
    decode_span: int = 0
    #: perf_counter at decode dispatch start (decode_time_s accounting)
    t0: float = 0.0
    #: engine-clock stamp set by the Engine right after dispatch; the
    #: step's token events and finishes carry it
    dispatched_at: float | None = None

    @property
    def empty(self) -> bool:
        """Nothing to collect and nothing to route (an idle dispatch)."""
        return (self.dev is None and not self.out.tokens and not self.out.finished
                and not self.out.preempted)


class DraftWorker:
    """The draft side of speculative decoding: a (small) model with its own
    dense float32 KV cache (``max_batch x max_seq_len``, never paged, never
    int8) that greedily proposes ``spec_k`` tokens per resident slot in one
    dispatch.  At most ``len(buckets)`` draft prefill shapes (resyncing a
    slot's draft cache from its token history after a turnover) plus one
    propose shape.  ``pos[i]`` / ``tok[i]`` are the (position, carry token)
    draft row i is synced to; -1 means unsynced (the executor's
    ``_host_dirty`` invalidates on every slot turnover)."""

    def __init__(self, cfg, params, serve_cfg, buckets, spec_k, device: torch.device,
                 shard: SlotShard | None = None):
        self.cfg = cfg
        self.params = params
        self.sc = serve_cfg
        self.buckets = tuple(buckets)
        self.spec_k = int(spec_k)
        self.device = device
        nb = serve_cfg.max_batch
        #: the slots whose cache rows this rank holds (``shard_decode``)
        self.shard = shard
        rows = nb if shard is None else shard.hi - shard.lo
        self.caches = kv_cache.init_caches(cfg, rows, serve_cfg.max_seq_len, dtype=torch.float32,
                                           quantized=False, device=device)
        self.pos = [-1] * nb
        self.tok = [0] * nb
        self._prefill_shapes: set[tuple[int, int]] = set()

    def bucket_for(self, n: int) -> int | None:
        """Smallest draft prefill bucket covering ``n`` history tokens (None:
        the history outgrew every bucket, and the slot decodes plainly)."""
        return next((b for b in self.buckets if b >= n), None)

    def _prefill_batch(self, tokens: torch.Tensor, lengths: torch.Tensor, slots) -> None:
        """Rebuild draft cache rows from token histories in one bucketed
        dispatch (pad rows: length 0, slot ``max_batch``, dropped)."""
        nb, bucket = tokens.shape
        mask = torch.arange(bucket, device=self.device)[None, :] < lengths[:, None]
        tokens = torch.where(mask, tokens, 0)
        small = kv_cache.init_caches(self.cfg, nb, self.sc.max_seq_len, dtype=torch.float32,
                                     quantized=False, device=self.device)
        _, filled, _ = lm.forward(self.params, self.cfg, {"tokens": tokens}, mode="prefill",
                                  caches=small, device=self.device, in_place=True)
        kv_cache.mask_cache_tail(filled, lengths)
        if self.shard is not None:  # every rank ran every row: keep its slots' rows
            slots = self.shard.local_slots(slots)
        kv_cache.insert_prefill_dense(self.caches, filled, slots)

    def propose(self, tokens, positions, active) -> torch.Tensor:
        """``spec_k`` greedy tokens per active row, (spec_k, B): row i
        processes its carry token at ``positions[i]`` (writing its KV) and
        takes the argmax, as the target's decode steps minus sampling.
        Inactive rows freeze; their repeated same-position writes are
        idempotent."""
        tok, pos, toks = tokens, positions, []
        for _ in range(self.spec_k):
            logits, _, _ = lm.forward(self.params, self.cfg, {"tokens": tok[:, None]},
                                      mode="decode", caches=self.caches, positions=pos,
                                      device=self.device, in_place=True)
            tok = torch.where(active, logits[:, -1].argmax(-1).to(tok.dtype), tok)
            pos = torch.where(active, pos + 1, pos)
            toks.append(tok)
        return torch.stack(toks)

    def sync(self, need: list[tuple[int, list[int]]], tel: dict) -> None:
        """Resync draft cache rows from their token histories, grouped by
        the smallest covering bucket (``need`` rows fit one); an empty
        history just marks the row synced."""
        groups: dict[int, list[tuple[int, list[int]]]] = {}
        for i, hist in need:
            if hist:
                groups.setdefault(self.bucket_for(len(hist)), []).append((i, hist))
        nb = self.sc.max_batch
        for bucket in sorted(groups):
            toks = np.zeros((nb, bucket), np.int64)
            lengths = np.zeros((nb,), np.int64)
            slot_arr = np.full((nb,), nb, np.int64)
            for row, (i, hist) in enumerate(groups[bucket]):
                toks[row, :len(hist)] = hist
                lengths[row] = len(hist)
                slot_arr[row] = i
            if (nb, bucket) not in self._prefill_shapes:
                self._prefill_shapes.add((nb, bucket))
                tel["draft_prefill_compiles"] = tel.get("draft_prefill_compiles", 0) + 1
            self._prefill_batch(upload(toks, self.device), upload(lengths, self.device),
                                slot_arr)


class ModelExecutor:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        serve_cfg: ServeConfig | None = None,
        kernel: dict | None = None,
        seed: int = 0,
        replica: int = 0,
        draft: tuple[ModelConfig, Any] | None = None,
        *,
        device: str | torch.device = "cuda",
    ):
        self.serve_cfg = serve_cfg or ServeConfig()
        sc = self.serve_cfg
        if sc.decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, got {sc.decode_steps}")
        if sc.max_prefill_per_step < 0:
            raise ValueError("max_prefill_per_step must be >= 0 (0 = fill all free slots)")
        self.device = resolve_device(device)
        params_lib.check_on(params, self.device)
        # the engine's own stream for unseeded sampled rows, salted by the
        # replica index (seeded rows are position-keyed: no salt reaches them)
        self.replica = int(replica)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(_salted_seed(int(seed), self.replica))

        # precision: ServeConfig.policy wins, else the model's own policy
        if sc.policy is not None:
            policy = precision_lib.get_policy(sc.policy)
            cfg = dataclasses.replace(cfg, precision=policy)
        else:
            policy = precision_lib.model_policy(cfg)
        self.cfg = cfg
        self.policy = policy
        self.plan = policy.resolve(cfg.n_layers)
        self.kernel = self.plan.kernel_defaults(kernel or {}) or {}
        self.params = precision_lib.apply_plan_to_params(params, self.plan)
        if self.plan.int8_kv_cache and self.plan.kv_cache.bits != 8:
            raise NotImplementedError(
                "the KV cache implements 8-bit per-token quantization only; "
                f"policy {policy.name!r} asks for {self.plan.kv_cache.bits}-bit"
            )
        self.quant_cache = bool(
            self.plan.int8_kv_cache
            and cfg.attn_kind in ("gqa", "mla")
            and cfg.family not in ("ssm", "hybrid")
        )
        # float32 caches whatever the weights' type, as the reference's; under
        # an int8 KV policy int8 codes plus float32 per-(token, head) scales
        self.cache_mgr = kv_cache.CacheManager(cfg, sc, quantized=self.quant_cache,
                                               dtype=torch.float32, device=self.device)
        self.kv_layout = self.cache_mgr.layout
        self.caches = self.cache_mgr.init_device_caches()
        self.slots = [Slot() for _ in range(sc.max_batch)]
        #: pipelined loop: dispatch and collect interleave across steps, and
        #: the decode carry stays on the device
        self.async_loop = bool(sc.async_loop)

        # shard_decode: params and cache pools placed as DTensors over the
        # host mesh (``placed``); every dispatch runs on their local tensors
        # (the kernels take plain tensors), which share the DTensors' storage
        self.mesh = None
        self.sharding_rules = None
        self.placed = None
        self.shard: SlotShard | None = None
        if sc.shard_decode:
            self._place_on_mesh()
        #: the slots [lo, hi) whose rows this rank's slot-indexed programs run
        self._rows = (0, sc.max_batch) if self.shard is None else (self.shard.lo, self.shard.hi)
        #: the logits of the last prefill / extend program, for _run_sample
        self._logits = None

        # Device-resident decode carry (async loop): the last dispatch's
        # final (token, position, active, budget) per slot.
        # ``_carry_valid[i]`` False means host state is authoritative for
        # slot i (admission, extend handoff, preemption, release since the
        # last dispatch).
        self._carry = None
        self._carry_valid = np.zeros((sc.max_batch,), bool)
        self._dispatch_seq = 0
        self._slot_dispatch = [-1] * sc.max_batch
        #: per-slot upper bound on the next write position while a dispatch
        #: is in flight (drives page ensure() when the true one is on device)
        self._pos_ub = [0] * sc.max_batch

        #: the prefill attends through the hand-written attention kernel (a
        #: card) rather than its plain version (the CPU): the reference's
        #: ``use_pallas``, gating ``bit_exact`` and ``cache_extend`` alike
        self.prefill_on_kernel = self.device.type != "cpu"
        # decode-path forward bitwise the prefill-path forward: float GQA,
        # exact softmax, and a prefill attend that is the plain version.
        # False for MLA (K / V re-materialized from the latent in another
        # order), under int8 KV and under the LUT softmax (decode's softmax
        # is exact), as the reference's
        self.bit_exact = (
            cfg.attn_kind == "gqa"
            and not self.quant_cache
            and self.kernel.get("softmax_mode", "safe") == "safe"
            and not self.prefill_on_kernel
        )
        # right-padding is sound only for position-addressed caches
        self.bucketable = self.cache_mgr.position_addressed
        self.buckets = (
            tuple(b for b in sc.resolved_buckets() if b <= sc.max_seq_len)
            if self.bucketable else ()
        )
        # the cache-extending prefill program: one (max_batch, extend_width)
        # shape whose window attend is the prefill path's plain math, so the
        # scheduler can plan prefill-skip / chunked / preemption-resume
        # admissions where the decode steps are not bitwise the prefill
        self.extend_width = (sc.prefill_chunk or max(self.buckets)) if self.buckets else 0
        self.cache_extend = bool(
            sc.cache_extend
            and self.bucketable
            and self.extend_width > 0
            and not self.prefill_on_kernel
        )
        self._prefill_shapes: set[tuple[int, int]] = set()
        self._decode_shapes: set[tuple[int, int]] = set()
        self._extend_shapes: set[tuple[int, int]] = set()
        #: the engine's phase tracer: its ``fence`` splits launch from device time
        self.tracer = NULL_TRACER
        self.tel = {
            "tokens_generated": 0,
            "prefill_compiles": 0,
            "prefill_dispatches": 0,
            "decode_compiles": 0,
            "extend_compiles": 0,
            "extend_dispatches": 0,
            "prefill_time_s": 0.0,
            "decode_time_s": 0.0,
            "extend_time_s": 0.0,
            "draft_tokens_proposed": 0,
            "draft_tokens_accepted": 0,
            "spec_dispatches": 0,
            "spec_time_s": 0.0,
            "steps": 0,
        }

        # Speculative decoding: the draft proposes spec_k greedy tokens per
        # resident decoding slot; the target verifies the window in one
        # extend dispatch and accepts the longest matching prefix plus a
        # correction token.  It needs the extend program.
        self.draft: DraftWorker | None = None
        self.spec_k = 0
        if sc.speculative and not self.cache_extend:
            warnings.warn(
                "speculative decoding disabled: it verifies drafts through "
                "the cache-extending prefill program, which this datapath "
                "does not support (cache_extend off, unbucketable cache, "
                "or the Pallas prefill kernel)",
                RuntimeWarning,
                stacklevel=3,
            )
        elif sc.speculative:
            dcfg, dparams = draft if draft is not None else (self.cfg, self.params)
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    "draft model must share the target vocabulary: "
                    f"draft {dcfg.vocab_size} vs target {cfg.vocab_size}"
                )
            self.spec_k = max(1, min(int(sc.spec_tokens), self.extend_width))
            self.draft = DraftWorker(dcfg, dparams, sc, self.buckets, self.spec_k, self.device,
                                     self.shard)

    def _place_on_mesh(self) -> None:
        """``shard_decode``: the host mesh over the process group, the params
        and every cache pool placed under the reference's shardings, and
        this rank's :class:`SlotShard`.  Over several ranks each computes
        with the whole parameters (gathered from their placement: the host
        mesh's model axis is 1) and with its local cache shards: its slots'
        rows of the dense slabs and of the page table, the paged pools
        whole.  The manager writes its rows of the page table."""
        from repro_torch.distributed import sharding as sharding_lib
        from repro_torch.launch.mesh import make_host_mesh

        self.mesh = make_host_mesh(device_type=self.device.type)
        rules = sharding_lib.ShardingRules(self.mesh)
        self.sharding_rules = rules
        param_sh = sharding_lib.param_shardings(rules, self.cfg, lm)
        cache_sh = self.cache_mgr.device_shardings(rules)
        self.placed = {
            "params": sharding_lib.map_tree(sharding_lib.place, self.params, param_sh),
            "caches": sharding_lib.map_tree(sharding_lib.place, self.caches, cache_sh),
        }
        world = self.mesh.size()
        whole = sharding_lib.gather if world > 1 else (lambda t: t.to_local())
        self.params = sharding_lib.map_tree(whole, self.placed["params"])
        self.caches = sharding_lib.map_tree(lambda t: t.to_local(), self.placed["caches"])
        self.cache_mgr.table_sharding = cache_sh["layers"].get("page_table")
        nb = self.serve_cfg.max_batch
        split = rules.batch_spec(1, shape=(nb,))[0] is not None and world > 1
        rank = self.mesh.get_local_rank("data")
        lo, hi = (rank * nb // world, (rank + 1) * nb // world) if split else (0, nb)
        self.shard = SlotShard(world, rank, lo, hi, split, self.mesh.get_group("data"))
        self.cache_mgr.table_rows = (lo, hi)

    def serve_worker(self) -> "ModelExecutor":
        """A worker rank's loop: run every device program rank 0 sends, on
        this rank's slots, until rank 0 closes (:meth:`close`); returns the
        executor (its ``tel`` counts the program shapes this rank ran).  Any
        error ends the loop and is raised: there is no fallback."""
        if self.shard is None or self.shard.rank == 0:
            raise ValueError("serve_worker runs on the ranks other than 0 of a shard_decode "
                             "engine; rank 0 runs serve.api.Engine")
        while True:
            name, args = self.shard.recv()
            if name == "close":
                return self
            getattr(type(self), name).__wrapped__(self, *args)

    def close(self) -> None:
        """Rank 0 of a ``shard_decode`` engine: end the worker ranks' loops
        (a no-op otherwise)."""
        if self.shard is not None and self.shard.controls and not self.shard.closed:
            self.shard.send(("close", ()))
            self.shard.closed = True

    # ------------------------------------------------------------- view --
    @property
    def caps(self) -> ExecutorCaps:
        """Capabilities schedulers plan against."""
        return ExecutorCaps(
            max_batch=self.serve_cfg.max_batch,
            max_seq_len=self.serve_cfg.max_seq_len,
            decode_steps=self.serve_cfg.decode_steps,
            buckets=self.buckets,
            bucketable=self.bucketable,
            paged=self.kv_layout == "paged",
            bit_exact=self.bit_exact,
            prefix_cache=self.cache_mgr.prefix_cache,
            cache_extend=self.cache_extend,
        )

    def kv_stats(self) -> dict:
        """Current KV-cache occupancy (layout, bytes, page utilization)."""
        return self.cache_mgr.stats().as_dict()

    # ------------------------------------------------------------ device --
    def _prefill_batch(self, tokens: torch.Tensor, lengths: torch.Tensor, slots,
                       shared=None, table_rows=None) -> torch.Tensor:
        """Prefill up to ``max_batch`` same-bucket prompts in ONE dispatch.

        ``tokens``: (max_batch, bucket) right-padded per row; ``lengths``:
        (max_batch,) true prompt lengths (0 for pad rows), both on the
        device.  ``slots``: (max_batch,) host destination slots; the value
        ``max_batch`` marks a pad row (dropped by the dense scatter, sent
        to the trash page by the paged one).  ``shared``: (max_batch,) host
        counts of leading prefix-cache pages whose recomputed values must
        not touch shared storage.  The model writes a dense scratch cache
        (the bucket rounded up to whole pages when paged, ``max_seq_len``
        when dense), which is tail-masked and inserted into the executor's
        caches (``table_rows``: the slots' host page-table rows, where this
        rank's device table lacks them).  Returns the per-row last-token
        logits (max_batch, V)."""
        nb, bucket = tokens.shape
        mask = torch.arange(bucket, device=tokens.device)[None, :] < lengths[:, None]
        tokens = torch.where(mask, tokens, 0)  # canonical pad id
        if self.kv_layout == "paged":
            ps = self.cache_mgr.page_size
            scratch_len = -(-bucket // ps) * ps
        else:
            scratch_len = self.serve_cfg.max_seq_len
        small = kv_cache.init_caches(self.cfg, nb, scratch_len, dtype=torch.float32,
                                     quantized=self.quant_cache, device=self.device)
        logits, filled, _ = lm.forward(self.params, self.cfg, {"tokens": tokens},
                                       mode="prefill", caches=small, kernel=self.kernel,
                                       device=self.device, in_place=True)
        # causal attention keeps positions < length independent of the pad
        # tail; each row's true logits live at index length - 1
        idx = (lengths - 1).clamp_min(0).long()
        last = logits[torch.arange(nb, device=logits.device), idx]
        kv_cache.mask_cache_tail(filled, lengths)
        self.cache_mgr.insert_prefill(self.caches, filled, slots, shared, table_rows)
        return last

    def _extend_batch(self, tokens: torch.Tensor, win_len: torch.Tensor,
                      starts: torch.Tensor) -> torch.Tensor:
        """Extend resident slots' caches by one token window each in ONE
        fixed-shape dispatch (the cache-extending prefill program).

        ``tokens``: (max_batch, extend_width) right-padded per row;
        ``win_len``: (max_batch,) valid tokens per row (0 = idle row);
        ``starts``: (max_batch,) each row's first write position; all on the
        device.  Row i is slot i, as in the decode steps.  The forward runs
        in ``extend`` mode: the window is written at ``starts + [0, W)``
        through the dense or paged scatter and attended with the prefill
        path's math against history + window; masked entries carry the
        ``max_seq_len`` sentinel (dropped / trash-paged).  Returns the full
        per-window logits (max_batch, W, V), which tail replay reads at each
        row's last valid position and speculative verification at every
        one, and the (max_batch, W) positions written."""
        nb, w = tokens.shape
        offs = torch.arange(w, device=tokens.device)
        mask = offs[None, :] < win_len[:, None]
        tokens = torch.where(mask, tokens, 0)  # canonical pad id
        positions = torch.where(mask, starts[:, None] + offs[None, :], self.serve_cfg.max_seq_len)
        logits, _, _ = lm.forward(self.params, self.cfg, {"tokens": tokens}, mode="extend",
                                  caches=self.caches, positions=positions, kernel=self.kernel,
                                  device=self.device, in_place=True)
        return logits, positions

    def _decode_scan(self, tokens, positions, active, rem, eos, temp, top_k, top_p, seed,
                     forced, n_forced):
        """Run ``decode_steps`` decode steps in one dispatch.

        All tensors are per slot (B,) on the device (this rank's slots
        under ``shard_decode``): ``tokens`` the last
        sampled token, ``positions`` the next write position, ``active``
        the live mask, ``rem`` the generation budget left, ``eos`` the eos
        id (-1 = none), and the sampling knobs.  Inactive slots freeze
        (token, position); re-running a frozen position is idempotent for
        position-addressed caches (retired paged slots write the trash
        page) and harmless for retired SSM slots (re-prefill overwrites
        their state).  ``forced``: (T, B) teacher-forced next tokens,
        ``n_forced``: (B,) how many leading steps force each slot (the
        prefill-skip and chunked-prefill tail): a forced step writes its
        prompt token's KV, emits nothing and leaves the budget and the
        eos/budget deactivation alone.  No host synchronisation inside.
        Returns (per-step tokens (T, B), per-step emit masks (T, B), final
        token, position, active mask and budget)."""
        sc = self.serve_cfg
        lo, hi = self._rows
        steps = torch.arange(sc.decode_steps, device=self.device)[:, None]
        flags = steps < n_forced[None, :]  # (T, B)
        tok, pos, act, budget = tokens, positions, active, rem
        toks, emits = [], []
        for t in range(sc.decode_steps):
            logits, _, _ = lm.forward(self.params, self.cfg, {"tokens": tok[:, None]},
                                      mode="decode", caches=self.caches, positions=pos,
                                      kernel=self.kernel, device=self.device, in_place=True)
            # the whole batch's keys on every rank, this rank's rows of them
            keys = draw_keys(self.generator, sc.max_batch, self.device)[lo:hi]
            sampled = sample_tokens(logits[:, -1], keys, temperature=temp, top_k=top_k,
                                    top_p=top_p, seed=seed, positions=pos)
            flag_t = flags[t]
            nxt = torch.where(act, torch.where(flag_t, forced[t], sampled), tok)
            emit = act & ~flag_t
            budget = torch.where(emit, budget - 1, budget)
            new_pos = torch.where(act, pos + 1, pos)
            act = (act & (flag_t | ((nxt != eos) & (budget > 0)))
                   & (new_pos + 1 < sc.max_seq_len))
            tok, pos = nxt, new_pos
            toks.append(nxt)
            emits.append(emit)
        return torch.stack(toks), torch.stack(emits), tok, pos, act, budget

    # ---------------------------------------------------- device programs --
    # Each takes host operands only and runs on every rank of a shard_decode
    # engine (``_program``), in the same order, so every rank's caches and
    # generator advance alike.

    @_program
    def _run_flush(self, ops: dict) -> None:
        """The host_prep's device work (``CacheManager.take_flush``)."""
        self.caches = self.cache_mgr.apply_flush(self.caches, ops)

    @_program
    def _run_prefill(self, toks, lengths, slots, shared, table_rows, n: int) -> torch.Tensor:
        """One bucket prefill (:meth:`_prefill_batch`), replicated: every
        rank computes every row and keeps the rows of its slots (dense) or
        writes every row's pages (paged, ``table_rows`` the slots' host
        table rows).  Keeps its first ``n`` rows' logits for
        :meth:`_run_sample`."""
        self._count_shape("prefill", toks.shape)
        if self.shard is not None and self.kv_layout != "paged":
            slots = self.shard.local_slots(slots)
        last = self._prefill_batch(upload(toks, self.device), upload(lengths, self.device),
                                   slots, shared, table_rows)
        self._logits = last[:n]
        return self._logits

    @_program
    def _run_extend(self, toks, win_len, starts) -> torch.Tensor:
        """The cache-extending prefill program (:meth:`_extend_batch`) on
        this rank's slots; the paged rows it wrote go to every rank, and the
        logits (max_batch, W, V) come back in slot order, kept for
        :meth:`_run_sample`."""
        lo, hi = self._rows
        toks, win_len, starts = toks[lo:hi], win_len[lo:hi], starts[lo:hi]
        self._count_shape("extend", toks.shape)
        logits, positions = self._extend_batch(upload(toks, self.device),
                                               upload(win_len, self.device),
                                               upload(starts, self.device))
        if self._shares_rows:
            kv_cache.share_written_rows(self.caches["layers"], positions, self.shard.gather)
        self._logits = logits if self.shard is None else self.shard.gather(logits, 0)
        return self._logits

    @_program
    def _run_sample(self, at, knobs, positions) -> np.ndarray:
        """Sample one token per row of the last prefill / extend program's
        logits with per-row knob tuples at the processed tokens'
        ``positions``; ``at`` picks each row's window offset (None: the
        prefill's rows).  One copy back."""
        logits = self._logits
        if at is not None:
            logits = logits[torch.arange(logits.shape[0], device=logits.device),
                            upload(at, self.device)]
        keys = draw_keys(self.generator, logits.shape[0], self.device)
        return sample_tokens(logits, keys, **_knobs(knobs, positions, self.device)).cpu().numpy()

    @_program
    def _run_draft_sync(self, need: list[tuple[int, list[int]]]) -> None:
        """``DraftWorker.sync``: replicated, each rank keeping its slots' rows."""
        self.draft.sync(need, self.tel)

    @_program
    def _run_draft_propose(self, d_tok, d_pos, d_act) -> np.ndarray:
        """``DraftWorker.propose`` on this rank's slots: (spec_k, max_batch)
        in slot order, on the host."""
        lo, hi = self._rows
        props = self.draft.propose(upload(d_tok[lo:hi], self.device),
                                   upload(d_pos[lo:hi], self.device),
                                   upload(d_act[lo:hi], self.device))
        if self.shard is not None:
            props = self.shard.gather(props, 1)
        return props.cpu().numpy()

    @_program
    def _run_decode(self, ints, floats, valid):
        """The decode steps (:meth:`_decode_scan`) on this rank's slots.
        ``ints`` (8 + T, max_batch): token, position, live, budget, eos,
        top_k, seed, forced count, then the (T, max_batch) forced tokens;
        ``floats`` (2, max_batch): temperature, top_p; ``valid``: under the
        async loop, the slots whose device carry overrides the host rows
        (None: no carry).  The paged rows the steps wrote go to every rank;
        the results come back packed in one int32 (2T + 4, max_batch)
        tensor in slot order (rows [0, T) tokens, [T, 2T) emit masks, then
        the final token, position, active mask and budget), with, on a card,
        a non-blocking copy into pinned memory and the event after it."""
        lo, hi = self._rows
        self._count_shape("decode", (hi - lo, self.serve_cfg.decode_steps))
        ints_d = upload(ints[:, lo:hi], self.device)
        floats_d = upload(floats[:, lo:hi], self.device)
        tok, pos, act, rem, eos, top_k, seed, nfd = ints_d[:8]
        act = act.bool()
        if valid is not None:
            # device truth for the slots with an uncollected dispatch, host
            # truth where an admission / extend / release made it fresh; the
            # mask goes up as a copy (``upload``), so no later
            # ``_host_dirty`` reaches this merge
            v = upload(valid[lo:hi], self.device)
            c_tok, c_pos, c_act, c_rem = self._carry
            tok, pos = torch.where(v, c_tok, tok), torch.where(v, c_pos, pos)
            act = act & torch.where(v, c_act, True)
            rem = torch.where(v, c_rem, rem)
        toks_t, emit_t, tok_f, pos_f, act_f, rem_f = self._decode_scan(
            tok, pos, act, rem, eos, floats_d[0], top_k, floats_d[1], seed, ints_d[8:], nfd,
        )
        if self._shares_rows:  # each slot wrote within [pos, pos + T)
            window = pos[:, None] + torch.arange(self.serve_cfg.decode_steps, device=pos.device)
            kv_cache.share_written_rows(self.caches["layers"], window, self.shard.gather)
        if self.async_loop:
            self._carry = (tok_f, pos_f, act_f, rem_f)
        packed = torch.cat([toks_t, emit_t.int(), tok_f[None], pos_f[None],
                            act_f.int()[None], rem_f[None]])
        if self.shard is not None:
            packed = self.shard.gather(packed, 1)
        host = None
        if self.device.type == "cuda":  # pinned, without blocking; collect waits
            host = (packed.to("cpu", non_blocking=True), torch.cuda.Event())
            host[1].record()
        return packed, host

    @property
    def _shares_rows(self) -> bool:
        """A split program's paged writes must reach the other ranks."""
        return self.shard is not None and self.shard.split and self.kv_layout == "paged"

    # ----------------------------------------------------------- execute --
    def execute(self, decision: ScheduleDecision) -> StepOutput:
        """Apply one ``ScheduleDecision``: :meth:`dispatch` then
        :meth:`collect`, back to back (the async loop interleaves the two
        halves across steps instead)."""
        return self.collect(self.dispatch(decision))

    def dispatch(self, decision: ScheduleDecision) -> InflightStep:
        """The non-blocking half: reset preempted slots, activate admissions
        (prefix-skip and fork slots at once, prefill and chunked slots
        through their bucket dispatches), drain cache-extend windows, verify
        speculative drafts, then launch the decode steps and return without
        waiting for them.  Prefill, extend and verify stay internally
        synchronous (their tokens are sampled on the host); the decode
        steps, the steady state's hot path, are what pipelines.  The
        scheduler already did the host-side page bookkeeping."""
        tel = self.tel
        tel["steps"] += 1
        out = StepOutput(stats={"prefilled": 0, "decoded": 0})
        for idx, req in decision.preempted:
            # pages were freed by the scheduler; drop the execution state
            self.slots[idx] = Slot()
            self._host_dirty(idx)
            out.preempted.append(req)
        for adm in decision.admissions:
            slot = self.slots[adm.slot]
            slot.admit_seq = adm.admit_seq
            slot.admit_gen = adm.admit_gen
            if adm.mode in (MODE_SKIP, MODE_FORK):
                # the shared pages hold every position < write_from (a fork's
                # are its parent's, prompt and generated-into): no prefill
                # dispatch, the tail replays per the admission's split
                slot.active, slot.request = True, adm.request
                slot.pos = adm.write_from
                self._activate_tail(slot, adm, adm.write_from)
                self._host_dirty(adm.slot)
                out.stats["prefilled"] += 1
        for bucket, group in decision.prefill_groups.items():
            self._dispatch_prefill(bucket, group, out)
        self._dispatch_extend(decision, out)
        spec_served = self._dispatch_speculative(decision, out)
        return self._dispatch_decode(decision, out, exclude=spec_served)

    def collect(self, inflight: InflightStep) -> StepOutput:
        """The blocking half: wait for the decode results on the host (the
        one point the loop waits on the device), route emitted tokens into
        each slot's request, update slot state from the final carry, and
        retire finished slots.  A slot cancelled or turned over since the
        dispatch has its tokens discarded."""
        out = inflight.out
        if inflight.dev is None:
            return out
        with trace.span("collect", inflight.decode_span):
            tel = self.tel
            decision = inflight.decision
            if inflight.host is None:
                packed = inflight.dev.cpu().numpy()  # the dispatch's one transfer
            else:
                host, done = inflight.host
                done.synchronize()
                packed = host.numpy()
            t = self.serve_cfg.decode_steps
            toks_t, emit_t = packed[:t], packed[t:2 * t].astype(bool)
            tok_f, pos_f, act_f = packed[2 * t], packed[2 * t + 1], packed[2 * t + 2].astype(bool)
            tel["decode_time_s"] += time.perf_counter() - inflight.t0
            with trace.span("sample"):
                for idx in inflight.decode_set:
                    slot = self.slots[idx]
                    req = inflight.snapshot.get(idx)
                    if (
                        req is None
                        or req.cancelled
                        or not slot.active
                        or slot.request is not req
                        or slot.admit_seq != inflight.admit_seqs.get(idx, -2)
                    ):
                        # cancelled, preempted or turned over (the same request
                        # re-admitted too: the admit_seq stamp) since the
                        # dispatch; a preempted request regenerates them
                        continue
                    for step in range(t):
                        if not emit_t[step, idx]:
                            continue
                        req.generated.append(int(toks_t[step, idx]))
                        out.stats["decoded"] += 1
                        tel["tokens_generated"] += 1
                        out.tokens.append((req.uid, int(toks_t[step, idx]), len(req.generated) - 1))
                    slot.pos = int(pos_f[idx])
                    slot.last_token = int(tok_f[idx])
                    if decision.register_decoded:
                        # decode-completed full pages are shareable too on the
                        # bit-exact datapath
                        self.cache_mgr.register_filled(idx, req.resume_tokens, slot.pos)
                    if not act_f[idx]:
                        out.finished.append(req)
                        self._finish_slot(idx)
                    else:
                        self._retire(idx, out)
            # clear in-flight marks, unless a newer dispatch re-marked the slot
            for idx in inflight.decode_set:
                if self._slot_dispatch[idx] == inflight.seq:
                    self.slots[idx].inflight = False
            return out

    def _activate_tail(self, slot: Slot, adm: Admission, start: int) -> None:
        """Split an admission's unwritten token tail per its
        ``decode_from`` stamp: positions in [start, decode_from) replay
        through the cache-extending prefill program, positions from
        ``decode_from`` on teacher-force through the decode steps.  With
        ``decode_from == start`` (the bit-exact datapaths' plan) the whole
        tail rides the decode steps and the carry token is primed at once."""
        tail = list(adm.tokens[start:adm.decode_from])
        pend = list(adm.tokens[adm.decode_from:])
        if tail:
            slot.prefill_tail = tail
            slot.pending = pend
        else:
            slot.last_token = pend[0]
            slot.pending = pend[1:]

    def release(self, idx: int) -> None:
        """Free a resident slot's pages and execution state at once
        (request cancellation); safe on inactive slots.  A dispatch in
        flight over the slot keeps writing through its page table; stream
        order lands those writes before any later dispatch reuses the
        pages."""
        self.cache_mgr.free(idx)
        self.slots[idx] = Slot()
        self._host_dirty(idx)

    def _host_dirty(self, idx: int) -> None:
        """Host slot state is authoritative for ``idx``: the device carry
        must not override it at the next decode dispatch, and the slot's
        draft cache row must resync before it speculates again."""
        self._carry_valid[idx] = False
        self._pos_ub[idx] = self.slots[idx].pos
        if self.draft is not None:
            self.draft.pos[idx] = -1

    def _reserve_cap(self, req: Request) -> int:
        """The admission-time worst-case length of ``req``: the cap for a
        conservative page ``ensure`` while its true position is on device."""
        return min(len(req.prompt) + req.max_new_tokens, self.serve_cfg.max_seq_len)

    def _flush(self, copies: bool = True) -> None:
        """The host_prep's device syncs before a dispatch: victim-tier swaps,
        then (``copies``) copy-on-write page copies, then the page table."""
        ops = self.cache_mgr.take_flush(copies=copies)
        if ops is not None:
            self._run_flush(ops)

    def _dispatch_prefill(self, bucket: int, group: list[Admission], out: StepOutput):
        """One fixed-shape prefill dispatch filling every slot in ``group``
        (all rows share ``bucket``); pad rows carry the slot sentinel
        ``max_batch``.  A row's tokens are its effective prompt (prompt +
        generated-so-far for a resumed request) cut to ``fill_len``.  Only
        MODE_PREFILL rows sample a first token from the last-position
        logits; chunked rows activate with their tail split."""
        sc, tel, tr = self.serve_cfg, self.tel, self.tracer
        nb = sc.max_batch
        with trace.span("prefill") as sp:
            if sp is not trace.NULL:
                sp.set(bucket=bucket, rows=len(group), max_batch=nb,
                       fill_tokens=sum(adm.fill_len for adm in group),
                       uids=[adm.request.uid for adm in group])
            with trace.span("host_prep"):
                toks = np.zeros((nb, bucket), np.int64)
                lengths = np.zeros((nb,), np.int64)
                slots_arr = np.full((nb,), nb, np.int64)
                shared_arr = np.zeros((nb,), np.int64)
                for row, adm in enumerate(group):
                    n = adm.fill_len
                    toks[row, :n] = adm.tokens[:n]
                    lengths[row] = n
                    slots_arr[row] = adm.slot
                    shared_arr[row] = adm.shared_pages
                # victim-tier movement of this step's admissions lands before the
                # prefill runs: spills drain pages the scatter is about to
                # overwrite, swap-ins fill the columns it redirects to trash
                self._flush(copies=False)
            table_rows = self.cache_mgr.table_rows_of(slots_arr) if self._shares_rows else None
            t0 = time.perf_counter()
            with trace.span("launch"):
                last = self._run_prefill(toks, lengths, slots_arr, shared_arr, table_rows,
                                         len(group))
            with trace.span("device"):
                tr.fence((last, self.caches))
            tel["prefill_dispatches"] += 1
            with trace.span("sample"):
                first_tokens = self._run_sample(None, [adm.sampling for adm in group],
                                                [len(a.tokens) - 1 for a in group])
                for row, adm in enumerate(group):
                    slot = self.slots[adm.slot]
                    slot.active, slot.request = True, adm.request
                    self._host_dirty(adm.slot)
                    if adm.emits_first_token:
                        nxt = int(first_tokens[row])
                        adm.request.generated.append(nxt)
                        tel["tokens_generated"] += 1
                        out.tokens.append((adm.request.uid, nxt, len(adm.request.generated) - 1))
                        slot.pos = len(adm.tokens)  # next write position
                        slot.last_token = nxt
                    else:  # MODE_CHUNKED: the tail replays per the admission split
                        slot.pos = adm.fill_len
                        self._activate_tail(slot, adm, adm.fill_len)
                    out.stats["prefilled"] += 1
                    self._retire(adm.slot, out)
            tel["prefill_time_s"] += time.perf_counter() - t0

    def _count_shape(self, kind: str, shape: tuple[int, int]) -> None:
        """Count a program shape (``kind`` "prefill", "decode" or "extend")
        the first time this rank runs it: the reference's compile count."""
        shapes = getattr(self, f"_{kind}_shapes")
        if shape not in shapes:
            shapes.add(shape)
            self.tel[f"{kind}_compiles"] += 1

    def _dispatch_extend(self, decision: ScheduleDecision, out: StepOutput):
        """ONE fixed-shape dispatch draining every listed slot's prefill
        tail by up to ``extend_width`` tokens through the cache-extending
        prefill program.  A slot whose tail drains either hands off to its
        teacher-forced pending (preemption resume: the generated part
        replays through the decode math that wrote it) or samples its first
        token from the window's last-position logits, the logits a
        whole-prompt prefill would have given."""
        work = [i for i in decision.extend_slots
                if self.slots[i].active and self.slots[i].prefill_tail]
        if not work:
            return
        sc, tel, tr = self.serve_cfg, self.tel, self.tracer
        nb, w = sc.max_batch, self.extend_width
        with trace.span("extend") as sp:
            if sp is not trace.NULL:
                sp.set(uids=[self.slots[i].request.uid for i in work])
            with trace.span("host_prep"):
                toks = np.zeros((nb, w), np.int64)
                lens = np.zeros((nb,), np.int64)
                starts = np.zeros((nb,), np.int64)
                for i in work:
                    slot = self.slots[i]
                    n = min(len(slot.prefill_tail), w)
                    toks[i, :n] = slot.prefill_tail[:n]
                    lens[i] = n
                    starts[i] = slot.pos
                    # grow pages over the write range; shared pages overlapping
                    # it are copy-on-write replaced before the scatter
                    self.cache_mgr.ensure(i, slot.pos + n, write_from=slot.pos)
                # swaps before copy-on-write copies: a CoW destination can be a
                # just-evicted page whose rows must spill first
                self._flush()
            t0 = time.perf_counter()
            with trace.span("launch"):
                logits = self._run_extend(toks, lens, starts)
            with trace.span("device"):
                tr.fence((logits, self.caches))
            tel["extend_dispatches"] += 1
            with trace.span("sample"):
                # each row's true logits live at its window's last valid position
                idx = np.maximum(lens - 1, 0)
                knobs = [encode_sampling(self.slots[i].request if i in work else None,
                                         sc.temperature) for i in range(nb)]
                first_tokens = self._run_sample(idx, knobs, starts + idx)
                for i in work:
                    slot = self.slots[i]
                    n = int(lens[i])
                    del slot.prefill_tail[:n]
                    slot.pos += n
                    self._host_dirty(i)
                    if slot.prefill_tail:
                        continue  # another window next step
                    if slot.pending:
                        # resume handoff: the generated part teacher-forces
                        # through the decode steps from here
                        slot.last_token = slot.pending.pop(0)
                    else:
                        nxt = int(first_tokens[i])
                        slot.request.generated.append(nxt)
                        tel["tokens_generated"] += 1
                        out.tokens.append((slot.request.uid, nxt, len(slot.request.generated) - 1))
                        slot.last_token = nxt
                    # window-written full pages hold prefill-path content: as
                    # shareable as a bucket dispatch's
                    self.cache_mgr.register_filled(i, slot.request.resume_tokens, slot.pos)
                    self._retire(i, out)
            tel["extend_time_s"] += time.perf_counter() - t0

    def _dispatch_speculative(self, decision: ScheduleDecision, out: StepOutput) -> set[int]:
        """Advance eligible decode slots by up to ``spec_k + 1`` tokens in
        one draft-propose and one target-verify dispatch; returns the slots
        served (the decode steps skip them this step).

        The draft greedily proposes ``spec_k`` tokens per slot; the target
        verifies the window [carry, d1..d_{k-1}] through the extend program
        at starts = pos, whose logits at offset j are what the decode steps
        would have given at pos + j, so sampling them with the request's
        knobs at the same positions gives the target's own token s_j.  The
        accepted prefix is the run of s_j == d_j, and one correction token
        (s at the first mismatch) always ships: greedy output is the plain
        engine's.  Rejected positions hold stale KV that the next write
        overwrites.  Emission follows the decode steps' deactivation rules
        (eos, budget, the next position reaching max_seq_len); served slots
        are host-dirty, and the draft's sync stamp advances (the accepted
        prefix was written to the draft cache while proposing)."""
        if self.draft is None:
            return set()
        sc, tel, tr = self.serve_cfg, self.tel, self.tracer
        k, nb = self.spec_k, sc.max_batch
        cand: list[int] = []
        for i in sorted(set(decision.decode_slots)):
            slot = self.slots[i]
            if not slot.active or slot.prefill_tail or slot.pending:
                continue
            if slot.request.cancelled:
                continue
            if self.async_loop and self._carry_valid[i]:
                continue  # the device carry owns this slot's truth
            if slot.request.max_new_tokens <= len(slot.request.generated):
                continue
            if slot.pos + k > sc.max_seq_len - 1:
                continue  # near the cap: plain decode finishes it
            cand.append(i)
        if not cand:
            return set()
        with trace.span("verify") as sp:
            if sp is not trace.NULL:
                sp.set(uids=[self.slots[i].request.uid for i in cand])
            t0 = time.perf_counter()
            with trace.span("host_prep"):
                # resync draft rows whose (pos, carry) drifted from the target's
                need: list[tuple[int, list[int]]] = []
                fit: list[int] = []
                for i in cand:
                    slot = self.slots[i]
                    if self.draft.pos[i] == slot.pos and self.draft.tok[i] == slot.last_token:
                        fit.append(i)
                        continue
                    hist = list(slot.request.resume_tokens[:slot.pos])
                    if hist and self.draft.bucket_for(len(hist)) is None:
                        continue  # history outgrew the draft buckets
                    need.append((i, hist))
                    fit.append(i)
                cand = fit
                if not cand:
                    tel["spec_time_s"] += time.perf_counter() - t0
                    return set()
                if need:
                    self._run_draft_sync(need)
                for i, _ in need:
                    self.draft.pos[i] = self.slots[i].pos
                    self.draft.tok[i] = self.slots[i].last_token
                d_tok = np.zeros((nb,), np.int32)
                d_pos = np.zeros((nb,), np.int32)
                d_act = np.zeros((nb,), bool)
                for i in cand:
                    d_tok[i] = self.slots[i].last_token
                    d_pos[i] = self.slots[i].pos
                    d_act[i] = True
            with trace.span("launch"):
                props = self._run_draft_propose(d_tok, d_pos, d_act)  # (k, nb)
            with trace.span("host_prep"):
                # verify: ONE extend dispatch over [carry, d1..d_{k-1}]
                vt = np.zeros((nb, self.extend_width), np.int64)
                vl = np.zeros((nb,), np.int64)
                vs = np.zeros((nb,), np.int64)
                for i in cand:
                    slot = self.slots[i]
                    vt[i, 0] = slot.last_token
                    vt[i, 1:k] = props[:k - 1, i]
                    vl[i] = k
                    vs[i] = slot.pos
                    self.cache_mgr.ensure(i, slot.pos + k, write_from=slot.pos)
                self._flush()
            with trace.span("launch"):
                logits = self._run_extend(vt, vl, vs)
            with trace.span("device"):
                tr.fence((logits, self.caches))
            tel["spec_dispatches"] += 1
            with trace.span("sample"):
                knobs = [encode_sampling(self.slots[i].request if i in cand else None,
                                         sc.temperature) for i in range(nb)]
                # (k, nb): the target's own token at each window offset
                samp = np.stack([self._run_sample(np.full((nb,), t, np.int64), knobs, d_pos + t)
                                 for t in range(k)])
                served: set[int] = set()
                for i in cand:
                    slot = self.slots[i]
                    req = slot.request
                    d = [int(props[t, i]) for t in range(k)]
                    s = [int(samp[t, i]) for t in range(k)]
                    m = 0
                    while m < k and s[m] == d[m]:
                        m += 1
                    emitted = d[:m] + ([] if m == k else [s[m]])
                    req.draft_proposed += k
                    req.draft_accepted += m
                    tel["draft_tokens_proposed"] += k
                    tel["draft_tokens_accepted"] += m
                    base = slot.pos
                    n_emit = 0
                    for nxt in emitted:
                        req.generated.append(nxt)
                        out.stats["decoded"] += 1
                        tel["tokens_generated"] += 1
                        out.tokens.append((req.uid, nxt, len(req.generated) - 1))
                        n_emit += 1
                        if ((req.eos_id is not None and nxt == req.eos_id)
                                or len(req.generated) >= req.max_new_tokens
                                or base + n_emit + 1 >= sc.max_seq_len):
                            break
                    slot.pos = base + n_emit
                    slot.last_token = emitted[n_emit - 1]
                    self._host_dirty(i)
                    # the accepted positions were written to the draft cache
                    # while proposing: the draft is synced by construction
                    self.draft.pos[i] = slot.pos
                    self.draft.tok[i] = slot.last_token
                    self.cache_mgr.register_filled(i, req.resume_tokens, slot.pos)
                    self._retire(i, out)
                    served.add(i)
            tel["spec_time_s"] += time.perf_counter() - t0
            return served

    def _dispatch_decode(self, decision: ScheduleDecision, out: StepOutput,
                         exclude: frozenset[int] | set[int] = frozenset()) -> InflightStep:
        """Launch the decode steps for the decision's decode slots (slots
        outside it freeze for this dispatch; a slot still draining a prefill
        tail, or served speculatively, does not decode) and return the
        ``InflightStep`` without waiting.

        Every input is built on the host from slot state and goes up in two
        copies (the int32 rows and the float32 rows).  Under the async loop
        the device carry of the last dispatch is merged over them on the
        device (``torch.where`` on a mask copied up) for the slots whose
        host state is stale, so consecutive dispatches chain with no host
        round trip; page ``ensure`` then works on a conservative position
        upper bound, which can only over-cover the true write range, within
        the admission-time reservation.  The results come back through a
        non-blocking copy into pinned memory on a card."""
        sc, tel, tr = self.serve_cfg, self.tel, self.tracer
        decode_set = {i for i in decision.decode_slots
                      if self.slots[i].active and not self.slots[i].prefill_tail
                      and i not in exclude}
        if not decode_set:
            return InflightStep(out=out, decision=decision)
        nb, steps = sc.max_batch, sc.decode_steps
        use_carry = self.async_loop and self._carry is not None
        with trace.span("decode") as sp:
            if sp is not trace.NULL:
                sp.set(slots=len(decode_set), decode_steps=steps,
                       uids=[self.slots[i].request.uid for i in sorted(decode_set)])
            with trace.span("host_prep"):
                forced = np.zeros((steps, nb), np.int32)
                n_forced = np.zeros((nb,), np.int32)
                for idx in sorted(decode_set):
                    slot = self.slots[idx]
                    nf = min(len(slot.pending), steps)
                    if nf:
                        forced[:nf, idx] = slot.pending[:nf]
                        n_forced[idx] = nf
                        # consumed by THIS dispatch: trimming here keeps the next
                        # dispatch's forced window right before this one's collect
                        del slot.pending[:nf]
                    if use_carry and self._carry_valid[idx]:
                        # the true position is on the device: ensure up to the
                        # conservative bound, from the stale host pos (a lower
                        # bound) so copy-on-write covers the range
                        upto = min(self._pos_ub[idx] + steps, self._reserve_cap(slot.request))
                        self._pos_ub[idx] = upto
                        self.cache_mgr.ensure(idx, upto, write_from=slot.pos)
                        continue
                    # the steps advance at most min(decode_steps, forced tail +
                    # remaining budget) positions, within the admission-time
                    # reservation; the write range lets the manager copy-on-write
                    # a shared page before the dispatch writes it
                    rem_i = max(slot.request.max_new_tokens - len(slot.request.generated), 1)
                    upto = min(slot.pos + min(steps, nf + rem_i), sc.max_seq_len)
                    self.cache_mgr.ensure(idx, upto, write_from=slot.pos)
                    if self.async_loop:
                        self._pos_ub[idx] = upto
                self._flush()
                live = [s.active and i in decode_set for i, s in enumerate(self.slots)]
                knobs = [encode_sampling(s.request if live[i] else None, sc.temperature)
                         for i, s in enumerate(self.slots)]
                ints = np.stack([
                    np.array([s.last_token for s in self.slots], np.int32),
                    np.array([s.pos if s.active else 0 for s in self.slots], np.int32),
                    np.array(live, np.int32),
                    np.array([max(s.request.max_new_tokens - len(s.request.generated), 0)
                              if live[i] else 0 for i, s in enumerate(self.slots)], np.int32),
                    np.array([s.request.eos_id if s.active and s.request.eos_id is not None else -1
                              for s in self.slots], np.int32),
                    np.array([k[1] for k in knobs], np.int32),
                    np.array([k[3] for k in knobs], np.int32),
                    n_forced,
                ])
                floats = np.array([[k[0] for k in knobs], [k[2] for k in knobs]], np.float32)
                valid = self._carry_valid.copy() if use_carry else None
            t0 = time.perf_counter()
            with trace.span("launch"):
                packed, host = self._run_decode(np.concatenate([ints, forced]), floats, valid)
            with trace.span("device"):
                tr.fence(packed)
        if self.async_loop:
            # every row's output reflects its merged input, so the whole
            # carry is valid until the next host-side slot change
            self._carry_valid[:] = True
        snapshot = {i: self.slots[i].request for i in decode_set}
        admit_seqs = {i: self.slots[i].admit_seq for i in decode_set}
        self._dispatch_seq += 1
        for i in decode_set:
            self.slots[i].inflight = True
            self._slot_dispatch[i] = self._dispatch_seq
        return InflightStep(out=out, decision=decision, decode_set=tuple(sorted(decode_set)),
                            dev=packed, host=host, snapshot=snapshot, admit_seqs=admit_seqs,
                            seq=self._dispatch_seq, decode_span=sp.id, t0=t0)

    def _retire(self, idx: int, out: StepOutput):
        slot = self.slots[idx]
        if slot.active and (slot.request.done or slot.pos + 1 >= self.serve_cfg.max_seq_len):
            out.finished.append(slot.request)
            self._finish_slot(idx)

    def _finish_slot(self, idx: int):
        self.slots[idx] = Slot()
        self.cache_mgr.free(idx)
        self._host_dirty(idx)

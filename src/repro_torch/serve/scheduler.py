"""Scheduling layer of the serving stack: *policy only, no device work*
(port, by copy, of ``repro.serve.scheduler``).

The serving engine is split into three layers (see ``serve/api.py`` for
the client-facing one):

* **Scheduler** (this module) — decides, each engine step, which queued
  prompts are admitted into which bucket/slots, which resident slots
  decode, and which residents are preempted.  It owns the request queue
  and performs the host-side page-pool bookkeeping for its decisions
  (reservation, prefix-hit mapping, preemption frees) through the
  :class:`~repro_torch.serve.kv_cache.CacheManager` — all numpy/list state,
  never a device dispatch.  This module must stay importable without
  torch: it contains **no torch imports and no device dispatches**
  (test-enforced), which is what makes scheduling policy auditable and
  swappable without touching the device programs.
* **Executor** (``serve/executor.py``) — owns the device programs, the
  CacheManager and the device cache tree, and mechanically applies a
  :class:`ScheduleDecision` (prefill dispatches, the decode scan, slot
  bookkeeping).  It makes no policy choices.
* **Engine** (``serve/api.py``) — the client API (submit / stream /
  cancel / generate) looping ``scheduler.schedule -> executor.execute``.

The default :class:`FifoScheduler` reproduces the historical engine
behavior exactly: FIFO admission grouped by prefill bucket,
prefix-cache hit planning (prefill-skip), youngest-first page-aware
preemption, and **chunked prefill** (``ServeConfig.prefill_chunk``): a
long prompt is admitted by prefilling only its first ``prefill_chunk``
tokens through the bucketed prefill program and replaying the
remaining prompt tail incrementally, interleaved with resident decode
steps, so each step stalls residents by at most a chunk-sized dispatch
instead of a full-prompt-sized one.

Token replay picks whichever mechanism reproduces the cache's own
math on the engine's datapath, stamped per admission as
``decode_from``: positions before it ride the executor's
cache-extending prefill program (prefill-path math), positions from it
on teacher-force through the decode scan (decode-path math).
Bit-exact datapaths (float GQA, exact softmax, reference kernel) plan
``decode_from == write_from`` — the whole tail through the decode scan,
the historical behavior; every other datapath (MLA, int8 KV, LUT
softmax) replays prompt positions via cache-extend so skip / chunked /
resume stay token-identical there too.  The compiled-program set stays
at ``len(prefill_buckets)`` prefill + 1 decode programs, + 1 extend
program on the datapaths that need it (test-enforced).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import TYPE_CHECKING, Protocol, runtime_checkable

if TYPE_CHECKING:  # import-time dependency kept out of the policy layer
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serve.kv_cache import CacheManager, PrefixMatch


# ------------------------------------------------------------ requests --
@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int | None = None
    generated: list[int] = dataclasses.field(default_factory=list)
    #: original submission time; never restamped — the stable anchor for
    #: client-side latency (TTFT = first TokenEvent.ts - created_at)
    created_at: float = 0.0
    #: queue-wait clock; a preemption restamps it at requeue so the next
    #: admission's wait measures time-to-resume, not time-since-submit
    submitted_at: float = 0.0
    admitted_at: float = 0.0
    #: absolute completion deadline on the engine clock (None = no SLO);
    #: the EDF policy (serve/slo.py) orders the queue by it and may drop
    #: a queued request once it passes (finish_reason="deadline")
    deadline_at: float | None = None
    #: engine-clock time the request left the system (final token
    #: emitted, or dropped past-deadline); 0.0 while live.  Deadline
    #: met iff ``finished_at <= deadline_at``.
    finished_at: float = 0.0
    #: times this request was preempted (pages freed, re-queued to resume
    #: from prompt + generated-so-far); telemetry for the scheduler tests
    preemptions: int = 0
    #: set by Engine.cancel; a cancelled request emits no further tokens
    cancelled: bool = False
    #: per-request sampling knobs (None = engine default); resolved by
    #: :func:`encode_sampling` and threaded through the compiled
    #: programs as traced per-slot arrays (see ``serve/sampling.py``)
    temperature: float | None = None
    top_k: int | None = None
    top_p: float | None = None
    seed: int | None = None
    #: uid of the primary request this n-best sibling forked from
    #: (``Engine.submit(n=...)``); admission maps the parent's pages —
    #: prompt AND generated-so-far — copy-on-write instead of
    #: re-prefilling, when the parent is still resident
    fork_of: int | None = None
    #: speculative-decoding counters for this request (tokens the draft
    #: model proposed for it / the target model accepted)
    draft_proposed: int = 0
    draft_accepted: int = 0

    @property
    def done(self) -> bool:
        if self.eos_id is not None and self.generated and self.generated[-1] == self.eos_id:
            return True
        return len(self.generated) >= self.max_new_tokens

    @property
    def resume_tokens(self) -> list[int]:
        """Effective prompt at (re-)admission: the original prompt plus
        everything generated before any preemption."""
        return self.prompt + self.generated

    @property
    def queue_wait_s(self) -> float:
        return max(0.0, self.admitted_at - self.submitted_at)


@dataclasses.dataclass
class Slot:
    """One continuous-batching slot.  Execution state (``pos``,
    ``last_token``, ``pending``) is written by the executor; the
    admission stamps (``admit_seq``, ``admit_gen``) are scheduler
    bookkeeping carried on the slot record."""

    active: bool = False
    request: Request | None = None
    pos: int = 0  # next position to write (== current length)
    last_token: int = 0
    #: prompt-tail tokens still to be teacher-forced through the decode
    #: scan (prefix-skip / chunked-prefill admissions); drained
    #: decode_steps at a time
    pending: list[int] = dataclasses.field(default_factory=list)
    #: tokens still to be replayed through the cache-extending prefill
    #: program before ``pending`` (non-bit-exact skip / chunked / resume
    #: admissions); drained extend_width at a time, and the slot does
    #: not decode until this is empty
    prefill_tail: list[int] = dataclasses.field(default_factory=list)
    #: admission order stamp — preemption picks the youngest resident
    admit_seq: int = -1
    #: a decode dispatch referencing this slot is in flight and not yet
    #: collected (async loop).  Set by the executor at dispatch, cleared
    #: at collect (unless a newer dispatch re-marked the slot first).
    #: Policies MAY preempt an in-flight slot: the executor's dispatch
    #: snapshot discards the uncollected tokens at collect, and the
    #: resume replays from the host-visible ``generated`` — greedy
    #: streams regenerate the discarded tokens bit-identically.  Under
    #: the synchronous loop dispatch/collect run back-to-back and the
    #: scheduler never observes this True.
    inflight: bool = False
    #: generated-token count at (re-)admission: a slot is only
    #: preemptable once it has emitted at least one token this
    #: residency, so every preemption cycle nets forward progress (a
    #: skip-resumed or chunked slot replaying its forced tail would
    #: otherwise be preempted before ever sampling — a livelock)
    admit_gen: int = 0


# ------------------------------------------------------------ sampling --
#: traced-array sentinels for "knob off" (see ``serve/sampling.py``)
TOPK_OFF = 0
TOPP_OFF = 1.0
SEED_OFF = -1


def encode_sampling(
    req: Request | None, default_temperature: float = 0.0
) -> tuple[float, int, float, int]:
    """Resolve a request's sampling knobs to the traced-array encoding
    ``(temperature, top_k, top_p, seed)`` consumed by the compiled
    programs: ``None`` temperature inherits the engine default, off
    knobs map to their sentinels (top_k 0, top_p 1.0, seed -1).  Pure
    host arithmetic — this module stays device-free."""
    if req is None:
        return (0.0, TOPK_OFF, TOPP_OFF, SEED_OFF)
    t = default_temperature if req.temperature is None else req.temperature
    k = TOPK_OFF if not req.top_k else int(req.top_k)
    p = TOPP_OFF if req.top_p is None else float(req.top_p)
    s = SEED_OFF if req.seed is None else int(req.seed)
    return (float(t), k, p, s)


# ------------------------------------------------------------ decisions --
#: admission modes — how the prompt's KV gets into the cache
MODE_PREFILL = "prefill"  # whole effective prompt through one bucket dispatch
MODE_SKIP = "skip"        # prefix hit: no dispatch, tail teacher-forced
MODE_CHUNKED = "chunked"  # first chunk through a bucket dispatch, tail forced
MODE_FORK = "fork"        # n-best sibling: parent pages mapped CoW, no dispatch


@dataclasses.dataclass(frozen=True)
class Admission:
    """One planned slot tenancy.  ``tokens`` is the effective prompt
    (original prompt + generated-so-far for a preemption resume);
    ``fill_len`` of it rides the prefill dispatch (0 for prefix-skip).
    The unwritten tail splits at ``decode_from``: positions in
    [``write_from``, ``decode_from``) replay through the cache-extending
    prefill program, positions >= ``decode_from`` teacher-force through
    the decode scan.  ``decode_from == write_from`` (bit-exact
    datapaths) routes the whole tail through decode — the historical
    plan."""

    slot: int
    request: Request
    tokens: tuple[int, ...]
    mode: str  # MODE_PREFILL | MODE_SKIP | MODE_CHUNKED | MODE_FORK
    bucket: int  # padded dispatch length (0 for MODE_SKIP / MODE_FORK)
    fill_len: int  # prompt tokens the prefill dispatch computes
    write_from: int  # first position written after the prefill dispatch
    decode_from: int  # first position replayed through the decode scan
    shared_pages: int  # leading covered pages mapped at admit()/fork()
    admit_seq: int
    admit_gen: int
    #: of ``shared_pages``, how many were victim-tier hits: chunks whose
    #: rows were spilled to host memory and swap back into fresh device
    #: pages at this admission (CacheManager.flush_swaps applies the
    #: copies at the executor's next dispatch).  0 everywhere the tier
    #: is off; purely observational — the executor treats swapped pages
    #: exactly like device-shared ones (their columns are already mapped
    #: and must not be re-written by a prefill scatter)
    swapped_pages: int = 0
    #: resolved (temperature, top_k, top_p, seed) traced-array encoding
    #: for this tenancy (:func:`encode_sampling`); the executor stacks
    #: these into the per-slot sampling arrays
    sampling: tuple[float, int, float, int] = (0.0, TOPK_OFF, TOPP_OFF, SEED_OFF)

    @property
    def emits_first_token(self) -> bool:
        """Whether the prefill dispatch's last-position logits sample the
        first generated token (only when the dispatch saw the whole
        prompt; a chunk's logits predict a token we already have)."""
        return self.mode == MODE_PREFILL


@dataclasses.dataclass
class ScheduleDecision:
    """Explicit per-step plan consumed by the executor: which residents
    preempt, which queued prompts prefill into which bucket/slots, and
    which slots decode.  The scheduler has already performed the
    host-side page bookkeeping (``CacheManager.admit``/``free``) for
    everything listed here; the executor performs only device work and
    slot bookkeeping."""

    #: slots whose resident was preempted (pages already freed, request
    #: already re-queued); the executor resets the slot records
    preempted: list[tuple[int, Request]] = dataclasses.field(default_factory=list)
    #: new tenancies, in admission order
    admissions: list[Admission] = dataclasses.field(default_factory=list)
    #: bucket -> same-bucket admissions riding ONE prefill dispatch,
    #: ascending bucket order (MODE_SKIP admissions never appear here)
    prefill_groups: dict[int, list[Admission]] = dataclasses.field(default_factory=dict)
    #: slots that run the decode scan this step (residents surviving
    #: preemption + this step's admissions; the executor holds back any
    #: slot still draining a prefill tail)
    decode_slots: list[int] = dataclasses.field(default_factory=list)
    #: slots with cache-extend replay work this step (non-empty
    #: ``prefill_tail`` residents + admissions planning one)
    extend_slots: list[int] = dataclasses.field(default_factory=list)
    #: register decode-completed full pages in the prefix index (only
    #: sound on the bit-exact datapath, where decode-written KV is
    #: bitwise what a prefill of the same tokens would write)
    register_decoded: bool = False
    #: queued requests the policy removed past their deadline (never
    #: admitted this residency, so no pages to free); the API layer
    #: finishes them with ``finish_reason="deadline"`` and streams a
    #: terminal event — a drop is an answered request, never a silent one
    dropped: list[Request] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class ExecutorCaps:
    """Datapath capabilities the executor advertises; policies must plan
    within them (the scheduler never inspects device state directly)."""

    max_batch: int
    max_seq_len: int
    decode_steps: int
    buckets: tuple[int, ...]  # active prefill buckets (() = exact-length)
    bucketable: bool  # position-addressed cache: right-padding is sound
    paged: bool  # block-table page pool (vs dense slot slabs)
    #: decode-path forward bitwise identical to prefill-path forward
    #: (float GQA, exact softmax, reference kernel) — lets prompt
    #: positions replay through the decode scan
    bit_exact: bool
    prefix_cache: bool  # prefix index live (paged + kv_prefix_cache)
    #: cache-extending prefill program available — lets prompt positions
    #: replay with prefill-path math on any datapath, so prefill-skip,
    #: preemption-resume, and chunked prefill no longer require
    #: ``bit_exact``
    cache_extend: bool = False


@runtime_checkable
class Scheduler(Protocol):
    """Scheduling policy protocol.  ``schedule`` may query and perform
    host-side bookkeeping on the executor-owned CacheManager (admission
    reservations, preemption frees) but must never touch device state —
    every dispatch consequence must be spelled out in the returned
    :class:`ScheduleDecision`."""

    #: policy counters merged into Engine.telemetry; must at least carry
    #: ``prompts_admitted`` and ``queue_wait_s_total``
    stats: dict

    def enqueue(self, request: Request) -> None: ...

    def remove(self, uid: int) -> Request | None: ...

    @property
    def queue(self) -> list[Request]: ...

    def schedule(self, slots: list[Slot]) -> ScheduleDecision: ...


class FifoScheduler:
    """The default policy: FIFO admission bucketed by prompt length,
    prefix-cache hit planning, youngest-first page-aware preemption, and
    chunked prefill for long prompts (``ServeConfig.prefill_chunk``)."""

    def __init__(
        self,
        serve_cfg: ServeConfig,
        caps: ExecutorCaps,
        cache: CacheManager,
        clock=None,
    ):
        self.serve_cfg = serve_cfg
        self.caps = caps
        self.cache = cache
        #: the engine clock: wall time by default, a virtual clock under
        #: deterministic workload replay (serve/workloads.py StepClock) —
        #: every wait/deadline stamp in this layer reads it
        self.clock = clock if clock is not None else time.perf_counter
        self.queue: list[Request] = []
        self._admit_seq = 0
        if serve_cfg.prefill_chunk is not None and not caps.bucketable:
            raise ValueError(
                "prefill_chunk requires a bucketable (position-addressed) "
                "cache; SSM/hybrid state and rolling sliding-window "
                "buffers admit exact-length prompts only"
            )
        #: requested knobs the engine cannot honor, surfaced in telemetry
        #: (and warned once) instead of being silently swallowed
        disabled: list[str] = []

        def _disable(feature: str, reason: str) -> None:
            disabled.append(f"{feature}: {reason}")
            warnings.warn(
                f"serving knob {feature} is disabled on this engine: "
                f"{reason}",
                RuntimeWarning,
                stacklevel=4,
            )

        #: token replay on prompt positions must reproduce the cache's
        #: own math: either the decode scan is bitwise the prefill
        #: (bit_exact) or the executor offers the cache-extending
        #: prefill program (cache_extend) — this picks the mechanism
        self.extend_replay = caps.cache_extend and not caps.bit_exact
        replayable = caps.bit_exact or caps.cache_extend
        #: prefix hits skip the prefill dispatch (vs storage-only sharing)
        self.prefix_skip = caps.prefix_cache and replayable
        if serve_cfg.kv_prefix_cache and not caps.prefix_cache:
            _disable(
                "kv_prefix_cache",
                "prefix sharing needs the paged layout on a "
                "position-addressed cache (kv_layout='paged')",
            )
        elif caps.prefix_cache and not self.prefix_skip:
            _disable(
                "kv_prefix_cache (prefill-skip)",
                "hits dedup page storage only: the datapath is not "
                "bit-exact and the cache-extending prefill program is "
                "unavailable (Pallas kernel or cache_extend=False)",
            )
        #: n-best sibling admission (``Request.fork_of``): map the
        #: resident parent's pages — including generated-into ones —
        #: copy-on-write instead of re-prefilling.  Needs refcounted
        #: pages (paged layout) and a replayable datapath: the child
        #: re-processes the parent's last prompt token to sample its own
        #: first token, exactly like a full-coverage prefix-skip.
        self.fork_enabled = caps.paged and replayable
        #: page-aware preemption instead of FIFO head-of-line blocking
        self.preempt_enabled = (
            caps.paged and serve_cfg.kv_preemption and replayable
        )
        if serve_cfg.kv_preemption and not self.preempt_enabled:
            _disable(
                "kv_preemption",
                "preemption needs the paged layout and a datapath that "
                "can replay a resume's prompt (bit-exact decode or the "
                "cache-extending prefill program)",
            )
        #: chunked prefill: the chunk dispatch must reuse a bucketed
        #: program, and the prompt tail must be replayable
        self.chunk_len = (
            serve_cfg.prefill_chunk
            if (
                serve_cfg.prefill_chunk is not None
                and replayable
                and caps.buckets
            )
            else None
        )
        if serve_cfg.prefill_chunk is not None and self.chunk_len is None:
            _disable(
                "prefill_chunk",
                "chunk-tail replay needs prefill buckets and a datapath "
                "that can replay prompt positions (bit-exact decode or "
                "the cache-extending prefill program)",
            )
        if self.chunk_len is not None:
            if self.chunk_len < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1, got {self.chunk_len}"
                )
            if self.chunk_len > max(caps.buckets):
                raise ValueError(
                    f"prefill_chunk={self.chunk_len} exceeds the largest "
                    f"prefill bucket {max(caps.buckets)}; a chunk dispatch "
                    "must ride an existing bucketed program"
                )
        self.stats = {
            "prompts_admitted": 0,
            "queue_wait_s_total": 0.0,
            # created_at-anchored wait: admission minus ORIGINAL submit
            # time, summed over admissions.  Equal to queue_wait_s_total
            # until a preemption restamps submitted_at — from then on
            # this is the honest time-in-system-before-(re)admission the
            # restamped clock undercounts (includes prior residencies).
            "queue_wait_created_s_total": 0.0,
            "preemptions": 0,
            # prompt tokens never recomputed thanks to a prefix hit
            # (prefill-skip admissions only — real FLOP savings)
            "prefill_tokens_saved": 0,
            # prompt tokens whose pages were deduped by a prefix hit on
            # the storage-only path (recomputed, but no pages written)
            "prefix_tokens_shared": 0,
            # n-best siblings admitted by mapping the parent's pages CoW
            "forks": 0,
            # siblings whose parent had already left its slot, admitted
            # through a plain prefill instead (correct, just no sharing)
            "fork_fallbacks": 0,
            # requested-but-unhonorable knobs ("feature: reason")
            "disabled_features": disabled,
        }

    # ------------------------------------------------------------ queue --
    def enqueue(self, request: Request) -> None:
        self.queue.append(request)

    def remove(self, uid: int) -> Request | None:
        for i, req in enumerate(self.queue):
            if req.uid == uid:
                return self.queue.pop(i)
        return None

    def bucket_for(self, n: int) -> int:
        """Padded prefill length for an n-token prompt: the smallest bucket
        >= n, or n itself for unbucketable families / oversized prompts."""
        for b in self.caps.buckets:
            if b >= n:
                return b
        return n

    # ------------------------------------------------------- preemption --
    def _try_preempt(
        self, slots: list[Slot], free: list[int], decision: ScheduleDecision
    ) -> bool:
        """Preempt the youngest resident slot to unblock the queue head:
        free its pages (shared prefix pages survive via refcounts), stamp
        the preemption, and re-queue it right behind the head with
        prompt + generated-so-far as a resumable prompt.  Returns False
        when preemption is off or nothing is preemptable.

        A slot whose resume prompt no longer fits the largest configured
        prefill bucket is not preemptable: re-prefilling it would mint an
        exact-length program shape and silently blow the
        len(prefill_buckets) + 1 program budget.  Neither is a slot that
        has not emitted a token since its (re-)admission: preempting it
        would discard a residency that made no progress, and a
        skip-resumed slot still replaying its teacher-forced tail could
        be preempted every step forever (livelock).

        A slot with an uncollected decode dispatch in flight (async
        loop) IS preemptable: collect discards its in-flight tokens
        (executor snapshot guard) and the resume regenerates them, so
        greedy streams stay identical.  Excluding in-flight victims
        would starve preemption entirely under the pipelined loop —
        every decoding resident has a dispatch in flight at schedule
        time."""
        if not self.preempt_enabled:
            return False
        taken = {idx for idx, _ in decision.preempted}
        max_bucket = max(self.caps.buckets) if self.caps.buckets else None
        victims = [
            i for i, s in enumerate(slots)
            if s.active
            and i not in taken
            and len(s.request.generated) > s.admit_gen
            and (
                max_bucket is None
                or len(s.request.resume_tokens) <= max_bucket
            )
        ]
        if not victims:
            return False
        idx = self._pick_victim(victims, slots)
        req = slots[idx].request
        req.preemptions += 1
        # the wait clock restarts at requeue: the next admission's queue
        # wait measures time spent waiting to resume, not time since the
        # original submission (which would double-count the residency).
        # created_at never restamps — queue_wait_created_s_total keeps
        # the full time-in-system view.
        req.submitted_at = self.clock()
        self.stats["preemptions"] += 1
        self.cache.free(idx)
        decision.preempted.append((idx, req))
        free.append(idx)
        self.queue.insert(1, req)
        return True

    def _pick_victim(self, victims: list[int], slots: list[Slot]) -> int:
        """Choose which preemptable resident to evict.  FIFO preempts
        the youngest (largest admit_seq) so the head-of-line request
        displaces the least-progressed work; deadline-aware policies
        override this to protect urgent residents."""
        return max(victims, key=lambda i: slots[i].admit_seq)

    # ------------------------------------------------------------- fork --
    def _try_fork(
        self,
        head: Request,
        slots: list[Slot],
        free: list[int],
        decision: ScheduleDecision,
    ) -> str:
        """Try to admit the queue head — an n-best sibling — by mapping
        its resident parent's pages copy-on-write (generated-into pages
        included: this is what extends page sharing beyond prompts).

        Returns ``"admitted"`` on success, ``"wait"`` when the parent is
        resident but not yet covering the prompt (or pages are short and
        preemption cannot help) — the head blocks, FIFO order holds —,
        ``"retry"`` after a preemption freed pages, and ``"fallback"``
        when the parent already left its slot: the sibling then admits
        through the plain prefill path (correct, just no sharing)."""
        taken = {i for i, _ in decision.preempted}
        pidx = next(
            (
                i for i, s in enumerate(slots)
                if s.active
                and i not in taken
                and s.request is not None
                and s.request.uid == head.fork_of
            ),
            None,
        )
        if pidx is None:
            if any(
                a.request.uid == head.fork_of for a in decision.admissions
            ):
                # the parent is being admitted by THIS decision (the
                # common submit(n=...) burst): it is not in a slot yet,
                # but will be next step — wait instead of falling back
                return "wait"
            return "fallback"
        upto = len(head.prompt)
        if slots[pidx].pos < upto:
            # parent still prefilling its prompt (or its host position
            # is stale-low under the async loop): wait a step.  The
            # parent is resident and progressing, so this never wedges.
            return "wait"
        reserve_len = self._reserve_len(head)
        need = self.cache.fork_need(pidx, upto, reserve_len)
        if not self.cache.can_reserve(need):
            # preemption may evict the parent itself — the retry then
            # takes the fallback path, which is still correct
            return "retry" if self._try_preempt(slots, free, decision) else "wait"
        req = self.queue.pop(0)
        if req.admitted_at == 0.0:
            self.stats["prompts_admitted"] += 1
        req.admitted_at = self.clock()
        self.stats["queue_wait_s_total"] += req.queue_wait_s
        self.stats["queue_wait_created_s_total"] += max(
            0.0, req.admitted_at - req.created_at
        )
        idx = free.pop(0)
        self._admit_seq += 1
        shared = self.cache.fork(idx, pidx, upto, reserve_len)
        self.stats["forks"] += 1
        # every prompt position is already in the shared pages; the
        # child re-processes only the last prompt token (write_from) to
        # sample its own first token — prefill-skip mechanics with the
        # parent's live pages instead of the prefix index
        write_from = max(upto - 1, 0)
        decode_from = upto if self.extend_replay else write_from
        adm = Admission(
            slot=idx, request=req, tokens=tuple(req.prompt), mode=MODE_FORK,
            bucket=0, fill_len=0, write_from=write_from,
            decode_from=decode_from, shared_pages=shared,
            admit_seq=self._admit_seq, admit_gen=0,
            sampling=encode_sampling(req, self.serve_cfg.temperature),
        )
        decision.admissions.append(adm)
        self.stats["prefill_tokens_saved"] += write_from
        return "admitted"

    # -------------------------------------------------------- admission --
    def _reserve_len(self, req: Request) -> int:
        """Worst-case sequence length for a request: decode writes reach at
        most position prompt + max_new_tokens - 1 (capped by max_seq_len)."""
        return min(
            len(req.prompt) + req.max_new_tokens, self.serve_cfg.max_seq_len
        )

    def schedule(self, slots: list[Slot]) -> ScheduleDecision:
        """Plan one engine step.  FIFO order; when the queue head cannot
        get pages, either preempt the youngest resident (kv_preemption on
        the bit-exact datapath) or block the head until finished slots
        return pages (no reordering, no starvation either way)."""
        sc = self.serve_cfg
        # decode-written pages are only registerable in the prefix index
        # on the bit-exact datapath (elsewhere their content is decode
        # math, not what a prefill of the same tokens would write)
        decision = ScheduleDecision(
            register_decoded=self.prefix_skip and self.caps.bit_exact
        )
        cap = sc.max_prefill_per_step or sc.max_batch
        free = [i for i, s in enumerate(slots) if not s.active]
        n_admitted = 0
        while self.queue and free and n_admitted < cap:
            head = self.queue[0]
            if (
                self.fork_enabled
                and head.fork_of is not None
                and not head.generated
            ):
                outcome = self._try_fork(head, slots, free, decision)
                if outcome == "admitted":
                    n_admitted += 1
                    continue
                if outcome == "retry":
                    continue
                if outcome == "wait":
                    break
                # "fallback": parent gone for good (finished, cancelled,
                # or itself preempted) — sticky-demote the sibling to a
                # plain admission so it is planned (and counted) once
                head.fork_of = None
                self.stats["fork_fallbacks"] += 1
            seq = head.resume_tokens
            resume = bool(head.generated)
            # a preemption resume on the cache-extend path splits: the
            # prompt part replays with prefill math, the generated part
            # must replay through the decode scan (the math that wrote
            # those positions in the baseline stream)
            split = self.extend_replay and resume
            # reserve worst-case pages (prompt + generation budget) so
            # decode growth can never exhaust the pool mid-run; pages
            # still allocate lazily as the sequence actually grows.  A
            # prefix hit reserves only the unshared tail (+1 CoW page
            # when the first write lands inside a shared page).
            reserve_len = self._reserve_len(head)
            match = self.cache.match_prefix(seq)
            if match and split:
                # index pages hold prefill-path content; a split resume
                # may only share pages fully inside its original prompt
                # (host-tier hits included: keys count total coverage)
                keep = len(head.prompt) // self.cache.page_size
                if len(match.keys) > keep:
                    match = type(match)(
                        match.pages[:keep], match.keys[:keep],
                        keep * self.cache.page_size,
                    )
            skip = bool(match) and self.prefix_skip and len(seq) > 1
            # chunked prefill only applies where no prefix pages cover the
            # prompt (a hit always skips instead); a split resume without
            # a hit also admits chunked — its prefill dispatch may cover
            # at most the original prompt
            chunked = (
                not skip
                and not match
                and (
                    (self.chunk_len is not None and len(seq) > self.chunk_len)
                    or split
                )
            )
            if skip:
                write_from = min(match.tokens, len(seq) - 1)
            elif chunked:
                write_from = len(head.prompt) if split else self.chunk_len
                if self.chunk_len is not None:
                    write_from = min(write_from, self.chunk_len)
            else:
                write_from = len(seq)
            need = self.cache.admission_need(match, reserve_len, write_from)
            if not self.cache.can_reserve(need):
                if self._try_preempt(slots, free, decision):
                    continue  # pages (and a slot) came back; retry head
                break
            req = self.queue.pop(0)
            # queue wait ends at pop: prefill execution/compile time that
            # follows is prefill_time_s, not waiting.  A preemption-resume
            # adds its re-wait to the total but the prompt counts once.
            if req.admitted_at == 0.0:
                self.stats["prompts_admitted"] += 1
            req.admitted_at = self.clock()
            self.stats["queue_wait_s_total"] += req.queue_wait_s
            # the created_at-anchored companion key: for a preemption
            # resume this spans prior residencies too, so preempted
            # requests' time-in-system is never silently undercounted
            self.stats["queue_wait_created_s_total"] += max(
                0.0, req.admitted_at - req.created_at
            )
            n_admitted += 1
            idx = free.pop(0)
            self._admit_seq += 1
            shared = self.cache.admit(
                idx, seq, reserve_len,
                match=match, lazy_tail=skip or chunked,
                write_from=write_from,
                fill_len=write_from if chunked else None,
            )
            if skip:
                mode, bucket, fill_len = MODE_SKIP, 0, 0
                self.stats["prefill_tokens_saved"] += write_from
            elif chunked:
                mode = MODE_CHUNKED
                fill_len = write_from
                bucket = self.bucket_for(fill_len)
            else:
                mode = MODE_PREFILL
                fill_len = len(seq)
                bucket = self.bucket_for(fill_len)
                self.stats["prefix_tokens_shared"] += match.tokens if match else 0
            # where the unwritten tail switches from cache-extend replay
            # to decode-scan replay: everywhere on the legacy (bit-exact)
            # plan; past the original prompt for a split resume; past the
            # whole sequence for a fresh extend-path admission (the last
            # window's logits sample the first token, exactly as a
            # whole-prompt prefill dispatch would)
            if mode == MODE_PREFILL or not self.extend_replay:
                decode_from = write_from if mode != MODE_PREFILL else len(seq)
            elif resume:
                decode_from = max(write_from, len(head.prompt))
            else:
                decode_from = len(seq)
            adm = Admission(
                slot=idx, request=req, tokens=tuple(seq), mode=mode,
                bucket=bucket, fill_len=fill_len, write_from=write_from,
                decode_from=decode_from, shared_pages=shared,
                admit_seq=self._admit_seq, admit_gen=len(req.generated),
                swapped_pages=match.host_hits if match else 0,
                sampling=encode_sampling(req, sc.temperature),
            )
            decision.admissions.append(adm)
            if mode != MODE_SKIP:
                decision.prefill_groups.setdefault(bucket, []).append(adm)
        decision.prefill_groups = dict(sorted(decision.prefill_groups.items()))
        preempted = {idx for idx, _ in decision.preempted}
        decision.decode_slots = sorted(
            {i for i, s in enumerate(slots) if s.active and i not in preempted}
            | {a.slot for a in decision.admissions}
        )
        decision.extend_slots = sorted(
            {
                i for i, s in enumerate(slots)
                if s.active and s.prefill_tail and i not in preempted
            }
            | {
                a.slot for a in decision.admissions
                if a.decode_from > (
                    a.write_from
                    if a.mode in (MODE_SKIP, MODE_FORK)
                    else a.fill_len
                )
            }
        )
        return decision

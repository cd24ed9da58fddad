"""Execution layer of the serving stack: *device work only, no policy*
(port of ``repro.serve.executor``).

:class:`ModelExecutor` owns everything that touches the device: the
precision plan applied to the params, the ``CacheManager`` with the device
caches it writes in place, and the slot table (execution state: write
positions, carry tokens, pending teacher-forced tails).  It consumes an
explicit ``ScheduleDecision`` and applies it: reset preempted slots,
activate admissions, run one fixed-shape ``(max_batch, bucket)`` prefill
dispatch per bucket group, run ``decode_steps`` decode steps in one
dispatch, retire finished slots.  Every choice was made by the scheduler.

The program discipline is the reference's, counted the same way: at most
``len(prefill_buckets)`` prefill shapes (``prefill_compiles``) plus one
decode shape (``decode_compiles``).  The reference's decode scan is one
compiled program; here it is a Python loop over ``lm.forward`` whose
tokens, positions, active, budget and eos masks stay on the device, and
whose results cross to the host once per dispatch.  The caches are the
executor's own: every forward writes into them in place
(``lm.forward(..., in_place=True)``), never into a copy.

``bit_exact`` (the decode path's forward is bitwise the prefill path's for
the same token at the same position) holds on the CPU, where prefill
attends through the plain version (held by
``tests/test_torch_serve_engine.py``), and not on CUDA, where prefill
attends through the hand-written kernel: the reference's "Pallas streaming
attention" row (README, datapath capability matrix).  Not ported yet
(ROADMAP queue 1, item 8): the cache-extending prefill program (step 5;
``cache_extend`` reports False), the async loop (step 7), speculative
decoding and n-best (step 8), the victim tier (step 9) and
``shard_decode``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.core import precision as precision_lib
from repro_torch.device import resolve_device
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

#: ServeConfig switches of later slices, by their ROADMAP queue 1, item 8 step
_UNPORTED = (("async_loop", "step 7"), ("speculative", "step 8"),
             ("shard_decode", "shard_decode"))


def _check_ported(sc: ServeConfig) -> None:
    for name, step in _UNPORTED:
        if getattr(sc, name):
            raise NotImplementedError(
                f"ServeConfig.{name} is not ported yet (ROADMAP queue 1, item 8, {step})"
            )


def _salted_seed(seed: int, replica: int) -> int:
    """The generator seed of replica ``replica``: distinct (seed, replica)
    pairs give distinct unseeded streams (the reference folds the replica
    into its key the same way)."""
    if not replica:
        return seed
    return (seed * 0x9E3779B1 + replica * 0x85EBCA77 + 1) % (1 << 63)


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """One host->device copy of a fresh copy of ``a``: the device never
    aliases live host state."""
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


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
    """A dispatched-but-uncollected step.  ``out`` holds what the prefill
    dispatches produced (they sample on the host); the decode results are
    still on the device in ``dev`` until :meth:`ModelExecutor.collect`
    copies them back.  ``snapshot`` / ``admit_seqs`` pin each decode slot's
    request and admission stamp at dispatch, so a slot cancelled or turned
    over before collect has its tokens dropped."""

    out: StepOutput
    decision: ScheduleDecision
    #: slots the decode dispatch covered (sorted), () = no decode ran
    decode_set: tuple[int, ...] = ()
    #: the decode dispatch's results packed in one int32 device tensor:
    #: rows [0, T) tokens, [T, 2T) emit masks, then the final token,
    #: position, active mask and budget; None when no decode ran
    dev: Any = None
    snapshot: dict[int, Request] = dataclasses.field(default_factory=dict)
    admit_seqs: dict[int, int] = dataclasses.field(default_factory=dict)
    #: tracer stamp of the decode dispatch's return
    t_dispatch: float = 0.0
    #: perf_counter at decode dispatch start (decode_time_s accounting)
    t0: float = 0.0


class ModelExecutor:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        serve_cfg: ServeConfig | None = None,
        kernel: dict | None = None,
        seed: int = 0,
        replica: int = 0,
        *,
        device: str | torch.device = "cuda",
    ):
        self.serve_cfg = serve_cfg or ServeConfig()
        sc = self.serve_cfg
        if sc.decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, got {sc.decode_steps}")
        if sc.max_prefill_per_step < 0:
            raise ValueError("max_prefill_per_step must be >= 0 (0 = fill all free slots)")
        _check_ported(sc)
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
        self.quant_cache = bool(
            self.plan.int8_kv_cache
            and cfg.attn_kind in ("gqa", "mla")
            and cfg.family not in ("ssm", "hybrid")
        )
        if self.plan.int8_kv_cache and self.plan.kv_cache.bits != 8:
            raise NotImplementedError(
                "the KV cache implements 8-bit per-token quantization only; "
                f"policy {policy.name!r} asks for {self.plan.kv_cache.bits}-bit"
            )
        # float32 caches whatever the weights' type, as the reference's; under
        # an int8 KV policy int8 codes plus float32 per-(token, head) scales
        self.cache_mgr = kv_cache.CacheManager(cfg, sc, quantized=self.quant_cache,
                                               dtype=torch.float32, device=self.device)
        self.kv_layout = self.cache_mgr.layout
        self.caches = self.cache_mgr.init_device_caches()
        self.slots = [Slot() for _ in range(sc.max_batch)]
        # decode-path forward bitwise the prefill-path forward: float GQA,
        # exact softmax, and a prefill attend that is the plain version
        # (the CPU); on CUDA the prefill attends through the kernel.  False
        # for MLA (K / V re-materialized from the latent in another order),
        # under int8 KV and under the LUT softmax (decode's softmax is
        # exact), as the reference's
        self.bit_exact = (
            cfg.attn_kind == "gqa"
            and not self.quant_cache
            and self.kernel.get("softmax_mode", "safe") == "safe"
            and self.device.type == "cpu"
        )
        # right-padding is sound only for position-addressed caches
        self.bucketable = self.cache_mgr.position_addressed
        self.buckets = (
            tuple(b for b in sc.resolved_buckets() if b <= sc.max_seq_len)
            if self.bucketable else ()
        )
        # the cache-extending prefill program waits for item 8, step 5
        self.cache_extend = False
        self._prefill_shapes: set[tuple[int, int]] = set()
        self._decode_shapes: set[tuple[int, int]] = set()
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
                       shared=None) -> torch.Tensor:
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
        caches.  Returns the per-row last-token logits (max_batch, V)."""
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
        self.cache_mgr.insert_prefill(self.caches, filled, slots, shared)
        return last

    def _decode_scan(self, tokens, positions, active, rem, eos, temp, top_k, top_p, seed,
                     forced, n_forced):
        """Run ``decode_steps`` decode steps in one dispatch.

        All tensors are per slot (B,) on the device: ``tokens`` the last
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
        nb = tokens.shape[0]
        steps = torch.arange(sc.decode_steps, device=self.device)[:, None]
        flags = steps < n_forced[None, :]  # (T, B)
        tok, pos, act, budget = tokens, positions, active, rem
        toks, emits = [], []
        for t in range(sc.decode_steps):
            logits, _, _ = lm.forward(self.params, self.cfg, {"tokens": tok[:, None]},
                                      mode="decode", caches=self.caches, positions=pos,
                                      kernel=self.kernel, device=self.device, in_place=True)
            sampled = sample_tokens(logits[:, -1], draw_keys(self.generator, nb, self.device),
                                    temperature=temp, top_k=top_k, top_p=top_p, seed=seed,
                                    positions=pos)
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

    # ----------------------------------------------------------- execute --
    def execute(self, decision: ScheduleDecision) -> StepOutput:
        """Apply one ``ScheduleDecision``: :meth:`dispatch` then
        :meth:`collect`, back to back."""
        return self.collect(self.dispatch(decision))

    def dispatch(self, decision: ScheduleDecision) -> InflightStep:
        """Reset preempted slots, activate admissions (prefix-skip slots at
        once, prefill and chunked slots through their bucket dispatches),
        then launch the decode steps and return without waiting for them.
        The scheduler already did the host-side page bookkeeping."""
        if decision.extend_slots:
            raise NotImplementedError(
                "cache-extend replay is not ported yet (ROADMAP queue 1, item 8, step 5)"
            )
        tel = self.tel
        tel["steps"] += 1
        out = StepOutput(stats={"prefilled": 0, "decoded": 0})
        for idx, req in decision.preempted:
            # pages were freed by the scheduler; drop the execution state
            self.slots[idx] = Slot()
            out.preempted.append(req)
        for adm in decision.admissions:
            slot = self.slots[adm.slot]
            slot.admit_seq = adm.admit_seq
            slot.admit_gen = adm.admit_gen
            if adm.mode in (MODE_SKIP, MODE_FORK):
                # the shared pages hold every position < write_from; no
                # prefill dispatch, the tail replays through decode
                slot.active, slot.request = True, adm.request
                slot.pos = adm.write_from
                self._activate_tail(slot, adm, adm.write_from)
                out.stats["prefilled"] += 1
        for bucket, group in decision.prefill_groups.items():
            self._dispatch_prefill(bucket, group, out)
        return self._dispatch_decode(decision, out)

    def collect(self, inflight: InflightStep) -> StepOutput:
        """Copy the decode results to the host (the one point the loop
        waits on the device), route emitted tokens into each slot's
        request, update slot state from the final carry, and retire
        finished slots."""
        out = inflight.out
        if inflight.dev is None:
            return out
        tel, tr = self.tel, self.tracer
        decision = inflight.decision
        tr.collect_begin(inflight.t_dispatch)
        with tr.phase(tr.collect_phase):
            packed = inflight.dev.cpu().numpy()  # the dispatch's one transfer
        t = self.serve_cfg.decode_steps
        toks_t, emit_t = packed[:t], packed[t:2 * t].astype(bool)
        tok_f, pos_f, act_f = packed[2 * t], packed[2 * t + 1], packed[2 * t + 2].astype(bool)
        tel["decode_time_s"] += time.perf_counter() - inflight.t0
        with tr.phase("sample"):
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
                    continue  # cancelled or turned over since the dispatch
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
        return out

    def _activate_tail(self, slot: Slot, adm: Admission, start: int) -> None:
        """Split an admission's unwritten token tail: positions from
        ``decode_from`` on teacher-force through the decode steps (with
        ``decode_from == start``, the only plan without the cache-extend
        program, the whole tail does and the carry token is primed)."""
        if adm.decode_from > start:
            raise NotImplementedError(
                "cache-extend replay is not ported yet (ROADMAP queue 1, item 8, step 5)"
            )
        pend = list(adm.tokens[adm.decode_from:])
        slot.last_token = pend[0]
        slot.pending = pend[1:]

    def release(self, idx: int) -> None:
        """Free a resident slot's pages and execution state at once
        (request cancellation); safe on inactive slots."""
        self.cache_mgr.free(idx)
        self.slots[idx] = Slot()

    def _dispatch_prefill(self, bucket: int, group: list[Admission], out: StepOutput):
        """One fixed-shape prefill dispatch filling every slot in ``group``
        (all rows share ``bucket``); pad rows carry the slot sentinel
        ``max_batch``.  A row's tokens are its effective prompt (prompt +
        generated-so-far for a resumed request) cut to ``fill_len``.  Only
        MODE_PREFILL rows sample a first token from the last-position
        logits; chunked rows activate with their teacher-forced tail."""
        sc, tel, tr = self.serve_cfg, self.tel, self.tracer
        nb = sc.max_batch
        with tr.phase("host_prep"):
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
            self.caches = self.cache_mgr.write_table(self.caches)
        if (nb, bucket) not in self._prefill_shapes:
            self._prefill_shapes.add((nb, bucket))
            tel["prefill_compiles"] += 1
        t0 = time.perf_counter()
        with tr.phase("dispatch"):
            last = self._prefill_batch(_to_device(toks, self.device),
                                       _to_device(lengths, self.device), slots_arr, shared_arr)
        with tr.phase("device"):
            tr.fence((last, self.caches))
        tel["prefill_dispatches"] += 1
        with tr.phase("sample"):
            knobs = np.array([adm.sampling for adm in group], np.float64)
            first_tokens = sample_tokens(
                last[:len(group)], draw_keys(self.generator, len(group), self.device),
                temperature=_to_device(knobs[:, 0].astype(np.float32), self.device),
                top_k=_to_device(knobs[:, 1].astype(np.int32), self.device),
                top_p=_to_device(knobs[:, 2].astype(np.float32), self.device),
                seed=_to_device(knobs[:, 3].astype(np.int32), self.device),
                positions=_to_device(np.array([len(a.tokens) - 1 for a in group], np.int32),
                                     self.device),
            ).cpu().numpy()  # one transfer for the group
            for row, adm in enumerate(group):
                slot = self.slots[adm.slot]
                slot.active, slot.request = True, adm.request
                if adm.emits_first_token:
                    nxt = int(first_tokens[row])
                    adm.request.generated.append(nxt)
                    tel["tokens_generated"] += 1
                    out.tokens.append((adm.request.uid, nxt, len(adm.request.generated) - 1))
                    slot.pos = len(adm.tokens)  # next write position
                    slot.last_token = nxt
                else:  # MODE_CHUNKED: the tail replays through decode
                    slot.pos = adm.fill_len
                    self._activate_tail(slot, adm, adm.fill_len)
                out.stats["prefilled"] += 1
                self._retire(adm.slot, out)
        tel["prefill_time_s"] += time.perf_counter() - t0

    def _dispatch_decode(self, decision: ScheduleDecision, out: StepOutput) -> InflightStep:
        """Launch the decode steps for the decision's decode slots (slots
        outside it freeze for this dispatch) and return the
        ``InflightStep`` without waiting.  Every input is built on the host
        from slot state and crosses to the device in two copies (the int32
        rows and the float32 rows)."""
        sc, tel, tr = self.serve_cfg, self.tel, self.tracer
        decode_set = {i for i in decision.decode_slots
                      if self.slots[i].active and not self.slots[i].prefill_tail}
        if not decode_set:
            return InflightStep(out=out, decision=decision)
        nb, steps = sc.max_batch, sc.decode_steps
        with tr.phase("host_prep"):
            forced = np.zeros((steps, nb), np.int32)
            n_forced = np.zeros((nb,), np.int32)
            for idx in sorted(decode_set):
                slot = self.slots[idx]
                nf = min(len(slot.pending), steps)
                if nf:
                    forced[:nf, idx] = slot.pending[:nf]
                    n_forced[idx] = nf
                    del slot.pending[:nf]
                # the steps advance at most min(decode_steps, forced tail +
                # remaining budget) positions, within the admission-time
                # reservation; the write range lets the manager copy-on-write
                # a shared page before the dispatch writes it
                rem_i = max(slot.request.max_new_tokens - len(slot.request.generated), 1)
                self.cache_mgr.ensure(
                    idx, min(slot.pos + min(steps, nf + rem_i), sc.max_seq_len),
                    write_from=slot.pos,
                )
            self.caches = self.cache_mgr.flush_copies(self.caches)
            self.caches = self.cache_mgr.write_table(self.caches)
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
            ints_d = _to_device(np.concatenate([ints, forced]), self.device)
            floats_d = _to_device(floats, self.device)
        if (nb, steps) not in self._decode_shapes:
            self._decode_shapes.add((nb, steps))
            tel["decode_compiles"] += 1
        t0 = time.perf_counter()
        with tr.phase("dispatch"):
            tok, pos, act, rem, eos, top_k, seed, nfd = ints_d[:8]
            toks_t, emit_t, tok_f, pos_f, act_f, rem_f = self._decode_scan(
                tok, pos, act.bool(), rem, eos, floats_d[0], top_k, floats_d[1], seed,
                ints_d[8:], nfd,
            )
            packed = torch.cat([toks_t, emit_t.int(), tok_f[None], pos_f[None],
                                act_f.int()[None], rem_f[None]])
        with tr.phase("device"):
            tr.fence(packed)
        snapshot = {i: self.slots[i].request for i in decode_set}
        admit_seqs = {i: self.slots[i].admit_seq for i in decode_set}
        return InflightStep(out=out, decision=decision, decode_set=tuple(sorted(decode_set)),
                            dev=packed, snapshot=snapshot, admit_seqs=admit_seqs,
                            t_dispatch=tr.mark_dispatch(), t0=t0)

    def _retire(self, idx: int, out: StepOutput):
        slot = self.slots[idx]
        if slot.active and (slot.request.done or slot.pos + 1 >= self.serve_cfg.max_seq_len):
            out.finished.append(slot.request)
            self._finish_slot(idx)

    def _finish_slot(self, idx: int):
        self.slots[idx] = Slot()
        self.cache_mgr.free(idx)

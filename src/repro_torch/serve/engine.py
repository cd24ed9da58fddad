"""Deprecated monolithic serving facade (port of ``repro.serve.engine``).

The serving engine was split into three layers — scheduling policy
(``serve/scheduler.py``), device execution (``serve/executor.py``), and
the client-facing streaming API (``serve/api.py``).  This module keeps
the old ``ServingEngine`` surface alive for one release as a thin shim
over :class:`repro_torch.serve.api.Engine`: numerics are identical (the shim
adds no logic of its own), but every construction emits a
``DeprecationWarning``.  Migrate:

    ``ServingEngine(cfg, params, sc)``   -> ``Engine(cfg, params, sc)``
    ``uid = eng.submit(p, n)``           -> ``h = eng.submit(p, max_new_tokens=n)``
    ``eng.run()``                        -> ``eng.generate()``
    (new) token streaming                -> ``for ev in eng.stream(h): ...``
    (new) cancellation                   -> ``eng.cancel(h)``

See README "Serving API" for the full migration table.
"""

from __future__ import annotations

import warnings
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.serve.api import Engine
from repro_torch.serve.scheduler import Request  # noqa: F401  (re-export)


class ServingEngine:
    """Deprecated: use :class:`repro_torch.serve.Engine` (``generate`` /
    ``stream``) instead.  Delegates everything to a wrapped Engine —
    same scheduler, same executor, token streams bit-identical."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        serve_cfg: ServeConfig | None = None,
        kernel: dict | None = None,
        seed: int = 0,
        *,
        device: str | torch.device = "cuda",
    ):
        warnings.warn(
            "ServingEngine is deprecated and will be removed next release; "
            "use repro_torch.serve.Engine (Engine.generate replaces run, "
            "Engine.stream adds token streaming)",
            DeprecationWarning,
            stacklevel=2,
        )
        self._engine = Engine(cfg, params, serve_cfg, kernel=kernel, seed=seed, device=device)

    def close(self) -> None:
        """End a ``shard_decode`` engine's worker ranks (``Engine.close``)."""
        self._engine.close()

    # ------------------------------------------------------- old surface --
    def submit(self, prompt: list[int], max_new_tokens: int = 16,
               eos_id: int | None = None) -> int:
        return self._engine.submit(
            prompt, max_new_tokens=max_new_tokens, eos_id=eos_id
        ).uid

    def run(self, max_steps: int = 10_000) -> dict[int, Request]:
        return self._engine.generate(max_steps=max_steps)

    def step(self) -> dict:
        return self._engine.step()

    def result(self, uid: int) -> Request | None:
        return self._engine.result(uid)

    @property
    def has_work(self) -> bool:
        return self._engine.has_work

    def kv_stats(self) -> dict:
        return self._engine.kv_stats()

    def bucket_for(self, n: int) -> int:
        return self._engine.scheduler.bucket_for(n)

    @property
    def prefill_buckets(self) -> tuple[int, ...]:
        """Active buckets; empty for exact-length (v1-style) prefill."""
        return self._engine.executor.buckets

    @property
    def telemetry(self) -> dict:
        return self._engine.telemetry

    # ------------------------------------------------ legacy attributes --
    # The monolith exposed its internals; tests and tooling built on them
    # keep working against the split layers for the deprecation window.
    @property
    def cfg(self):
        return self._engine.executor.cfg

    @property
    def serve_cfg(self):
        return self._engine.serve_cfg

    @property
    def params(self):
        return self._engine.executor.params

    @property
    def policy(self):
        return self._engine.executor.policy

    @property
    def plan(self):
        return self._engine.executor.plan

    @property
    def kernel(self):
        return self._engine.executor.kernel

    @property
    def quant_cache(self):
        return self._engine.executor.quant_cache

    @property
    def cache_mgr(self):
        return self._engine.executor.cache_mgr

    @property
    def kv_layout(self):
        return self._engine.executor.kv_layout

    @property
    def caches(self):
        return self._engine.executor.caches

    @property
    def slots(self):
        return self._engine.executor.slots

    @property
    def generator(self):
        return self._engine.executor.generator

    @property
    def _queue(self):
        return self._engine.scheduler.queue

    @property
    def _finished(self):
        return self._engine._finished

    def _prefill_batch(self, *args, **kwargs):
        return self._engine.executor._prefill_batch(*args, **kwargs)

    @property
    def _bucketable(self):
        return self._engine.executor.bucketable

    @property
    def _bit_exact_resume(self):
        return self._engine.executor.bit_exact

    @property
    def _prefix_skip(self):
        return self._engine.scheduler.prefix_skip

    @property
    def _preempt_enabled(self):
        return self._engine.scheduler.preempt_enabled

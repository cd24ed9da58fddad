"""Serving substrate of the port (``repro.serve`` in PyTorch): the cache
specs, the paged layout and ``CacheManager`` (``kv_cache``), per-slot
sampling (``sampling``), the scheduling policies (``scheduler``, ``slo``,
``workloads``), the phase tracer (``phases``), the device executor
(``executor``, with the speculative ``DraftWorker``), the client API
(``api.Engine``), the data-parallel front door (``router.ReplicaRouter``),
the deprecated ``ServingEngine`` shim and the CLI (``cli``).

The names below are the reference package's exports, resolved on first
use: ``models.attention`` imports ``serve.kv_cache``, and the executor
imports ``models.lm``, so loading them all here would make an import cycle.
"""

import importlib

_EXPORTS = {
    "kv_cache": ("kv_cache", None),
    "CacheManager": ("kv_cache", "CacheManager"),
    "CacheStats": ("kv_cache", "CacheStats"),
    "PrefixMatch": ("kv_cache", "PrefixMatch"),
    "Admission": ("scheduler", "Admission"),
    "ExecutorCaps": ("scheduler", "ExecutorCaps"),
    "FifoScheduler": ("scheduler", "FifoScheduler"),
    "Request": ("scheduler", "Request"),
    "ScheduleDecision": ("scheduler", "ScheduleDecision"),
    "Scheduler": ("scheduler", "Scheduler"),
    "Slot": ("scheduler", "Slot"),
    "DeadlineScheduler": ("slo", "DeadlineScheduler"),
    "DraftWorker": ("executor", "DraftWorker"),
    "InflightStep": ("executor", "InflightStep"),
    "ModelExecutor": ("executor", "ModelExecutor"),
    "StepOutput": ("executor", "StepOutput"),
    "Engine": ("api", "Engine"),
    "serve_worker": ("api", "serve_worker"),
    "ReplicaRouter": ("router", "ReplicaRouter"),
    "RequestHandle": ("api", "RequestHandle"),
    "TokenEvent": ("api", "TokenEvent"),
    "ServingEngine": ("engine", "ServingEngine"),
    "SamplingParams": ("sampling", "SamplingParams"),
    "sample": ("sampling", "sample"),
    "sample_tokens": ("sampling", "sample_tokens"),
    "NULL_TRACER": ("phases", "NULL_TRACER"),
    "NullTracer": ("phases", "NullTracer"),
    "OverlapTracer": ("phases", "OverlapTracer"),
    "PhaseTracer": ("phases", "PhaseTracer"),
    "make_tracer": ("phases", "make_tracer"),
    "ArrivalEvent": ("workloads", "ArrivalEvent"),
    "ReplayReport": ("workloads", "ReplayReport"),
    "StepClock": ("workloads", "StepClock"),
    "load_trace": ("workloads", "load_trace"),
    "multi_tenant": ("workloads", "multi_tenant"),
    "poisson": ("workloads", "poisson"),
    "replay": ("workloads", "replay"),
    "save_trace": ("workloads", "save_trace"),
    "synchronous": ("workloads", "synchronous"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    mod = importlib.import_module(f"{__name__}.{module}")
    return mod if attr is None else getattr(mod, attr)

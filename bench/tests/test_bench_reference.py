"""A cell is compared against the reference its configuration file names:
the drivers, the controls and the FLOP readers find the reference module
by the file's ``reference`` and use it through one interface."""

import importlib
import sys
import types

import pytest

from bench import harness

from test_bench_faults import _gw_run, _serve_run

SPEC = harness.load_spec()


def _probe(real: str, calls: list, alter):
    """A reference module named ``probe_<real>``: ``real``'s, with every
    logits tensor it gives passed through ``alter``; each ``build`` noted
    in ``calls``."""
    module = importlib.import_module(f"bench.references.{real}")
    probe = types.ModuleType(f"bench.references.probe_{real}")

    class Altered:
        def __init__(self, inner):
            self.inner = inner

        def logits(self, *a, **kw):
            return alter(self.inner.logits(*a, **kw))

    def build(*a, **kw):
        calls.append(kw)
        return Altered(module.build(*a, **kw))

    probe.build, probe.CONTROLS = build, module.CONTROLS
    return probe


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_each_configuration_names_a_reference_with_the_interface(config):
    cell = next(w["name"] for w in SPEC["workloads"] if w["config"] == config)
    _, conf, _ = harness.cell_files(SPEC, cell)
    ref = harness.reference(conf)
    assert ref.__name__ == f"bench.references.{conf['reference']}"
    assert callable(ref.build) and conf["control"] in ref.CONTROLS
    assert callable(getattr(ref, "flops_per_event", None) or getattr(ref, "window_flops", None))


def _shift(t):
    return t + 0.05


def _favour_token_0(t):
    out = t.clone()
    out[..., 0] += 100.0  # the best token of every position is now token 0
    return out


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_the_run_is_compared_against_the_reference_its_file_names(kind, monkeypatch):
    real, alter = {"encoder": ("physics_encoder", _shift),
                   "decoder": ("decoder_lm", _favour_token_0)}[kind]
    calls = []
    probe = _probe(real, calls, alter)
    monkeypatch.setitem(sys.modules, probe.__name__, probe)
    name = probe.__name__.rsplit(".", 1)[1]
    r = _gw_run("float", reference=name) if kind == "encoder" else _serve_run(
        "int8_serve", reference=name)
    assert calls, "the driver did not build the named reference"
    assert not r.correct, r.checks

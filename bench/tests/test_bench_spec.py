"""BENCHMARK.json keeps to the contract's form, and every name in it finds
its file."""

import json
import re

import pytest

from bench import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_the_full_check_fits_its_time_at_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units_use_only_the_allowed_characters():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in SPEC[group]]
        assert len(got) == len(set(got)), group


def test_entries_have_just_the_contract_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, want in keys.items():
        for e in SPEC[group]:
            assert set(e) - {"workloads"} == want, e
    for e in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for e in SPEC["per_layer"]:
        assert 1 <= len(e["layer"]) <= 200


def test_bounds_and_sources():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in harness.end_to_end(SPEC, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert harness.per_layer(SPEC, w["name"]), w["name"]
        assert w["chips"] == 1


def test_every_moves_names_an_end_to_end_metric_each_of_its_cells_reports():
    for m in SPEC["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in [e["name"] for e in harness.end_to_end(SPEC, cell)], (m, cell)


def test_every_configuration_is_used_and_every_pair_appears_once():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    spec_cell, config, traffic = harness.cell_files(SPEC, cell)
    assert PATH.match(next(c["file"] for c in SPEC["configs"] if c["name"] == spec_cell["config"]))
    assert config["model"] and config["policy"] and config["check"]
    assert (harness.BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
    assert (harness.BENCH / "references" / f"{config['reference']}.py").is_file()
    from repro_torch.kernels import build

    assert config["kernels"] and set(config["kernels"]) <= set(build.KERNELS)
    for m in harness.per_layer(SPEC, cell):
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_reduced_names_no_width():
    widths = re.compile(r"(hidden|intermediate|latent|state|proj|head|_dim$|_rank$|expan|d_model"
                        r"|d_ff|experts_per)")
    for c in SPEC["configs"]:
        for k in c["reduced"]:
            assert not widths.search(k), k

"""The control, the plain reference computed in the nearest precision below
the configuration's, is judged as a run is and comes out not correct.

On the card (TF32 and the matrix-product routes it changes exist only
there): each cell's own control at a size a test run holds.  On the CPU:
the control's numbers take the run's checks, name for name and limit for
limit.  ``bench/control.py`` reads the same at each cell's own size."""

import time

import pytest

from bench import control, harness

from test_bench_faults import _serve_run

SPEC = harness.load_spec()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cells_control_comes_out_not_correct(card, cell):
    c, conf, mix = harness.cell_files(SPEC, cell)
    if mix["driver"] == "batch_stream":
        mix = dict(mix, batch=2048, pool_batches=2)
    r = harness.Run(workload=cell, cell=c, config=conf, traffic=mix, seed=2**31 + 5,
                    seconds=3.0, trace=False, device=card, t_process=time.perf_counter())
    harness.driver(mix).run(r)
    assert r.correct, r.checks
    judged = control.control_run(r, conf["control"])
    assert not judged.correct, judged.checks


def test_a_control_is_judged_against_the_runs_own_limits():
    r = _serve_run("int8_serve")
    assert r.correct, r.checks
    judged = control.control_run(r, r.config["control"])
    assert set(judged.checks) == set(r.checks)
    for name, (value, limit) in judged.checks.items():
        assert limit == r.checks[name][1]
        assert value > r.checks[name][0]  # int4 weights and KV part from the served tokens


@pytest.mark.parametrize("reading,correct", [(0.5, True), (1.5, True), (1.6, False)])
def test_a_reading_over_its_limit_is_not_correct(reading, correct):
    r = harness.Run(workload="w", cell={"chips": 1}, config={}, traffic={}, seed=1, seconds=1.0,
                    trace=False, device=None, t_process=0.0,
                    checks={"max_served_gap": (0.1, 1.5)})
    assert r.judged({"max_served_gap": reading, "other": 9.0}).correct is correct
    with pytest.raises(KeyError):
        r.judged({"other": 0.0})

"""No module the benchmark loads, in a run or in its reference, is JAX or
the JAX package: the top-level names are compared whole."""

import subprocess
import sys
import textwrap

from bench import harness

PROBE = textwrap.dedent("""
    import json, sys, time
    sys.path[:0] = [{root!r}, {src!r}]
    import torch
    from bench import harness, control, stats, trace, traffic, yardstick
    from bench.drivers import batch_stream, closed_loop, common
    from bench.references import decoder_lm, numerics, physics_encoder
    spec = harness.load_spec()
    conf = json.load(open({root!r} + "/bench/configs/gw.paper_vu13p.json"))
    mix = json.load(open({root!r} + "/bench/traffic/reprocess-8192.json"))
    mix.update(batch=16, pool_batches=2)
    r = harness.Run(workload="gw-emulate-8192", cell={{"chips": 1}}, config=conf, traffic=mix,
                    seed=3, seconds=0.3, trace=False, device=torch.device("cpu"),
                    t_process=time.perf_counter())
    batch_stream.run(r)
    for m in harness.per_layer(spec, "gw-emulate-8192"):
        pass
    harness.read_per_layer(spec, r)
    print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
""")


def test_the_banned_names_are_compared_whole():
    sys.modules.setdefault("repro_torch_probe_name", sys)
    try:
        assert "repro" not in harness.banned_modules()
    finally:
        del sys.modules["repro_torch_probe_name"]


def test_a_run_and_its_reference_load_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(harness.ROOT),
                                                             src=str(harness.ROOT / "src"))],
                         capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "bench" in loaded
    assert not loaded & set(harness.BANNED), loaded & set(harness.BANNED)

"""``ServeConfig.shard_decode`` over two ranks (``serve.executor``: rank 0's
``Engine`` sends every device program, rank 1 runs them in
``serve_worker``, each computing its own slots) against the one-rank port
engine and the JAX package's engine with ``shard_decode`` on a host mesh of
data 2, on the CPU.

One spawned gloo job of two CPU processes (``tests/_torch_shard_worker.py``)
serves reduced granite-8b on the same converted parameters in every
scenario of its ``SCENARIOS``: dense and paged plus prefix cache, sync and
async loops, greedy and sampled rows (seeded, and on the engine's
generator), a tight pool that preempts and spills to the host tier, every
feature at once (async loop, EDF, prefix cache, preemption, chunked
prefill, speculative decoding with its draft, n-best forks), and a
``max_batch`` of 3 that two ranks do not divide.

- Rank 0's streams are bitwise the one-rank engine's in every scenario,
  and, in the paged greedy ones (the prefix cache under the async loop, the
  tight pool), the JAX engine's under ``shard_decode`` with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=2`` (its host mesh
  has data 2), run in a subprocess.
- Each rank computes its own contiguous run of slots in one decode shape;
  the undivided batch runs replicated on both; with everything on, each
  rank ran at most ``len(buckets)`` prefill shapes, one decode and one
  extend shape, and its draft at most ``len(buckets)`` prefill shapes.
"""

import os
import pickle
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from _torch_parity import numpy_tree  # noqa: E402
from _torch_shard_worker import (ARCH, GREEDY, SCENARIOS, engine_kwargs,  # noqa: E402
                                 run_workload)
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")

JAX_RUNNER = """
import pickle, sys
sys.path.insert(0, sys.argv[2])
import jax, jax.numpy as jnp
import _torch_shard_worker as w
from repro.configs import get_config
from repro.configs.base import ServeConfig
from repro.serve import Engine
raw = pickle.load(open(sys.argv[1] + "/params.pkl", "rb"))
cfg = get_config(w.ARCH, reduced=True)
params = jax.tree.map(jnp.asarray, raw)
out = {"devices": len(jax.devices())}
for name in w.GREEDY:
    fields, workload = w.SCENARIOS[name]
    eng = Engine(cfg, params, ServeConfig(**fields, shard_decode=True))
    out[name] = dict(run_workload=w.run_workload(eng, workload)["streams"],
                     mesh=dict(eng.executor.mesh.shape))
pickle.dump(out, open(sys.argv[1] + "/jax.pkl", "wb"))
"""


@pytest.fixture(scope="module")
def params_np():
    return numpy_tree(jlm.param_spec(jax_get_config(ARCH, reduced=True)), 17)


@pytest.fixture(scope="module")
def shard_job(tmp_path_factory, params_np):
    """Spawn the 2-process job once; each rank's results."""
    out = tmp_path_factory.mktemp("shard")
    torch.save({"params": params_np}, out / "inputs.pt")
    code = ("import sys, torch.multiprocessing as mp; sys.path.insert(0, sys.argv[2]); "
            "import _torch_shard_worker as w; "
            "mp.spawn(w.run, args=(2, sys.argv[1]), nprocs=2, join=True)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code, str(out), TESTS], capture_output=True,
                       text=True, env=env, timeout=400)
    assert r.returncode == 0, r.stderr[-4000:]
    return [torch.load(out / f"shard{k}.pt", weights_only=False) for k in range(2)]


@pytest.fixture(scope="module")
def one_rank(params_np):
    """Each scenario on the one-rank engine (no process group)."""
    cfg = get_config(ARCH, reduced=True)
    params = params_from_numpy(params_np, "cpu")
    out = {}
    for name, (fields, workload) in SCENARIOS.items():
        eng = Engine(cfg, params, ServeConfig(**fields), device="cpu", **engine_kwargs(workload))
        out[name] = run_workload(eng, workload)
    return out


@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory, params_np):
    """The greedy scenarios on the JAX engine with ``shard_decode`` over a
    host mesh of two CPU devices."""
    out = tmp_path_factory.mktemp("jax_shard")
    with open(out / "params.pkl", "wb") as f:
        pickle.dump(params_np, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run([sys.executable, "-c", JAX_RUNNER, str(out), TESTS],
                       capture_output=True, text=True, env=env, timeout=400)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(out / "jax.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_rank0_streams_equal_the_one_rank_engine(shard_job, one_rank, name):
    got, want = shard_job[0][name], one_rank[name]
    assert got["streams"] == want["streams"]
    assert all(len(t) > 0 for t in got["streams"].values())
    for k in ("preemptions", "swap_outs", "swap_ins", "prefix_hits", "forks",
              "draft_tokens_proposed", "cow_copies"):
        assert got["tel"][k] == want["tel"][k], k


@pytest.mark.parametrize("name", GREEDY)
def test_greedy_streams_equal_the_jax_engine_over_two_devices(shard_job, jax_engine, name):
    assert jax_engine["devices"] == 2
    assert jax_engine[name]["mesh"] == {"data": 2, "model": 1}
    assert list(shard_job[0][name]["streams"].values()) == [
        tuple(t) for t in jax_engine[name]["run_workload"].values()]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_each_rank_runs_its_own_slots_in_one_decode_shape(shard_job, name):
    fields, _ = SCENARIOS[name]
    nb = fields["max_batch"]
    shards = [rank[name]["counts"]["shard"] for rank in shard_job]
    if nb % 2:  # undivided: every rank runs every slot, the reference's fallback
        assert shards == [(0, nb, False, 2)] * 2
    else:
        assert shards == [(0, nb // 2, True, 2), (nb // 2, nb, True, 2)]
    for rank, (lo, hi, _, _) in zip(shard_job, shards):
        counts = rank[name]["counts"]
        assert counts["decode_shapes"] == [(hi - lo, fields["decode_steps"])]
        assert counts["decode_compiles"] == 1
        assert 1 <= counts["prefill_compiles"] <= len(counts["buckets"])


def test_program_count_with_everything_enabled_on_each_rank(shard_job):
    """The reference's budget on each rank: at most ``len(buckets)`` prefill
    shapes, one decode and one extend shape; the draft at most
    ``len(buckets)`` prefill shapes; the features really ran."""
    for rank in shard_job:
        c = rank["everything"]["counts"]
        assert c["prefill_compiles"] <= len(c["buckets"])
        assert c["decode_compiles"] <= 1 and c["extend_compiles"] <= 1
        assert c["draft_prefill_shapes"] <= len(c["buckets"])
    tel = shard_job[0]["everything"]["tel"]
    assert tel["draft_tokens_proposed"] > 0 and tel["forks"] > 0


def test_tight_pool_preempts_and_swaps_over_two_ranks(shard_job):
    tel = shard_job[0]["tight-greedy"]["tel"]
    assert tel["preemptions"] > 0 and tel["swap_outs"] > 0 and tel["swap_ins"] > 0
    assert shard_job[0]["paged-async-greedy"]["tel"]["prefix_hits"] > 0


def test_a_worker_rank_cannot_build_the_engine(monkeypatch):
    """Rank 1 of a shard_decode job runs ``serve_worker``, not an Engine."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 1)
    cfg = get_config(ARCH, reduced=True)
    params = params_from_numpy(numpy_tree(jlm.param_spec(jax_get_config(ARCH, reduced=True)),
                                          3), "cpu")
    with pytest.raises(ValueError, match="serve_worker"):
        Engine(cfg, params, ServeConfig(max_batch=2, max_seq_len=64, shard_decode=True),
               device="cpu")

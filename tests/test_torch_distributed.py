"""The port's sharded training path against the JAX package, on the CPU.

- ``ShardingRules``: the spec and the recorded ``fallbacks`` of every
  parameter leaf of every config (published and reduced) equal the
  reference's, on meshes of 16 devices ((1, 16), as
  ``tests/test_sharding_properties.py``), (4, 4), (16, 16) and
  (2, 16, 16).  The rules read only a mesh's shape and axis names, so both
  packages take an abstract mesh (``jax.sharding.AbstractMesh``,
  ``launch.mesh.AbstractMesh``); the batch and cache specs likewise.
- One spawned gloo job of 4 CPU processes on a (data 2, model 2) mesh
  (``tests/_torch_dist_worker.py``; ``init_method="file://"`` under
  ``tmp_path``, so no port is fixed):
  - two sharded train steps of reduced zamba2-1.2b (split over ``model``),
    each from the state the unsharded whole-batch step starts from, within
    1e-6 of that step's losses and its state within 1e-5 of that step's,
    save a parameter whose whole-batch gradient lies below Adam's eps
    (there m / (sqrt(v) + eps) turns float32 rounding into a step of up to
    lr; reduced zamba2 has one such element, off by 4.8e-4), which must be
    off by what the two runs' moments give through AdamW, to 1e-6; at most
    1e-3 of the parameters off by more than 1e-6;
  - the state saved from (2, 2) restores bitwise onto (4, 1) and
    unsharded;
  - the compressed all-reduce's codes and scales bitwise equal to the
    reference's ``_quantize_block`` on the same inputs, and its error
    feedback converging as ``test_compressed_allreduce_error_feedback_converges``;
  - ``ring_collective_matmul`` equal to the plain product (1e-4, as the
    reference's test);
  - the kernel wrappers refusing a DTensor.
- ``python -m repro_torch.launch.train --device cpu --arch mamba2-130m``.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ParallelismConfig as JParallelismConfig  # noqa: E402
from repro.distributed import collectives as jcollectives  # noqa: E402
from repro.distributed.sharding import ShardingRules as JShardingRules  # noqa: E402
from repro.distributed.sharding import cache_shardings as jcache_shardings  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ParallelismConfig  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    P,
    ShardingRules,
    cache_shardings,
    param_shardings,
    placements_for,
)
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import params as params_lib  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import abstract_train_state, train_state_logical_axes  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [((1, 16), ("data", "model")), ((4, 4), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
PLANS = {"default": {}, "sp_no_fsdp": dict(sp=True, fsdp=False), "dp_only": dict(
    tp=False, ep=False, fsdp=False)}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    return [("/".join(path), tree)]


def _rules(shape, axes, plan):
    return (JShardingRules(mesh=AbstractMesh(shape, axes), plan=JParallelismConfig(**plan)),
            ShardingRules(mesh=abstract_mesh(shape, axes), plan=ParallelismConfig(**plan)))


def test_parallelism_config_matches_reference():
    ours = {f.name: f.default for f in dataclasses.fields(ParallelismConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JParallelismConfig)}
    assert ours == ref


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("shape,axes", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_param_specs_and_fallbacks_match_reference(name, shape, axes, plan):
    for reduced in (False, True):
        jr, r = _rules(shape, axes, PLANS[plan])
        jspec = jlm.param_spec(jconfigs.get_config(name, reduced=reduced))
        tspec = lm.param_spec(configs.get_config(name, reduced=reduced))
        jabs, jaxes = dict(_leaves(jparams.abstract_params(jspec))), dict(
            _leaves(jparams.logical_axes(jspec)))
        tabs, taxes = dict(_leaves(params_lib.abstract_params(tspec))), dict(
            _leaves(params_lib.logical_axes(tspec)))
        assert set(jabs) == set(tabs)
        for k in sorted(jabs):
            assert tabs[k].device.type == "meta" and tuple(tabs[k].shape) == jabs[k].shape, k
            assert taxes[k] == tuple(jaxes[k]), k
            ref = tuple(jr.spec_for(tuple(jaxes[k]), jabs[k].shape))
            assert tuple(r.spec_for(taxes[k], tuple(tabs[k].shape))) == ref, (k, ref)
        assert r.fallbacks == jr.fallbacks


@pytest.mark.parametrize("shape,axes", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_batch_specs_match_reference(shape, axes):
    jr, r = _rules(shape, axes, {})
    for ndim in (1, 2, 3):
        for batch in (1, 2, 16, 32, 48, 512):
            s = (batch,) + (64,) * (ndim - 1)
            assert tuple(r.batch_spec(ndim, shape=s)) == tuple(jr.batch_spec(ndim, shape=s))
        assert tuple(r.batch_spec(ndim)) == tuple(jr.batch_spec(ndim))
    assert tuple(r.batch_spec(2, {1: "seq"}, shape=(32, 64))) == tuple(
        jr.batch_spec(2, {1: "seq"}, shape=(32, 64)))


# the SSM and hybrid caches are dense only (the engine falls back to dense)
@pytest.mark.parametrize("name,layout,quantized", [
    (name, layout, q) for name in ("granite-8b", "starcoder2-7b", "minicpm3-4b")
    for layout in ("dense", "paged") for q in (False, True)] + [
    (name, "dense", False) for name in ("zamba2-1.2b", "mamba2-130m")])
def test_cache_specs_match_reference(name, layout, quantized):
    jr, r = _rules((16, 16), ("data", "model"), {})
    kw = dict(page_size=16, num_pages=64) if layout == "paged" else {}
    jcfg, tcfg = jconfigs.get_config(name), configs.get_config(name)
    ref = jcache_shardings(jr, jcfg, 32, 1024, quantized=quantized, layout=layout, **kw)
    ours = cache_shardings(r, tcfg, 32, 1024, quantized=quantized, layout=layout, **kw)
    ref_specs = {k: tuple(v.spec) for k, v in _leaves(ref)}
    assert {k: tuple(v.spec) for k, v in _leaves(ours)} == ref_specs


def test_fallback_records_unshardable_axes():
    """40 experts on a 16-way model axis replicate and are recorded, as the
    reference's test on its 16-device mesh."""
    _, r = _rules((1, 16), ("data", "model"), {})
    spec = r.spec_for(("experts", "embed", "mlp"), (40, 64, 512))
    assert spec[0] is None and ("experts", 40) in r.fallbacks
    assert r.spec_for(("experts",), (48,))[0] == "model"


def test_train_state_abstract_and_axes_match_reference():
    tcfg, jcfg = configs.get_config("zamba2-1.2b", reduced=True), jconfigs.get_config(
        "zamba2-1.2b", reduced=True)
    ours = _leaves(abstract_train_state(tcfg, AdamW(schedule=lambda s: 1e-3)))
    ref = _leaves(jstep.abstract_train_state(jcfg, JAdamW(schedule=lambda s: 1e-3)))
    assert [k for k, _ in ours] == [k for k, _ in ref]
    for (k, t), (_, j) in zip(ours, ref):
        assert t.device.type == "meta" and tuple(t.shape) == j.shape, k
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name, k
    assert {k: tuple(v) for k, v in _leaves(train_state_logical_axes(tcfg))} == {
        k: tuple(v) for k, v in _leaves(jstep.train_state_logical_axes(jcfg))}


def test_param_shardings_placements():
    """A sharding's DTensor placements: Shard(d) on each mesh axis that
    splits tensor axis d (major axis first), Replicate() elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert placements_for(mesh, P(("pod", "data"), "model")) == (Shard(0), Shard(0), Shard(1))
    assert placements_for(mesh, P(None, "data")) == (Replicate(), Shard(1), Replicate())
    assert placements_for(mesh, P()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        placements_for(mesh, P(("data", "pod")))
    sh = param_shardings(ShardingRules(mesh=abstract_mesh((16, 16), ("data", "model"))),
                         configs.get_config("granite-8b"), lm)
    n = len(_leaves(params_lib.abstract_params(lm.param_spec(configs.get_config("granite-8b")))))
    assert len(_leaves(sh)) == n


def test_mesh_defaults_to_the_card(monkeypatch):
    """Without CUDA a mesh raises unless asked for the CPU; without a
    process group it raises too."""
    from repro_torch.launch import mesh as mesh_lib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_lib.make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    with pytest.raises(ValueError, match="rank"):
        abstract_mesh((2, 2), ("data",))


# --- the gloo job ---------------------------------------------------------


@pytest.fixture(scope="module")
def gloo_job(tmp_path_factory):
    """Spawn the 4-process job once; its outputs, read by the tests below."""
    out = tmp_path_factory.mktemp("gloo")
    code = ("import sys, torch.multiprocessing as mp; sys.path.insert(0, sys.argv[2]); "
            "import _torch_dist_worker as w; "
            "mp.spawn(w.run, args=(4, sys.argv[1]), nprocs=4, join=True)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code, str(out), os.path.join(ROOT, "tests")],
                       capture_output=True, text=True, env=env, timeout=240)
    assert r.returncode == 0, r.stderr[-4000:]
    return out


def _rank0(out):
    return torch.load(out / "rank0.pt", weights_only=False)


def test_sharded_step_equals_the_unsharded_step(gloo_job):
    """The sharded step, which splits zamba2 over ``model`` (so it is no
    longer bitwise any unsharded step's), against the whole-batch step, the
    reference's sharded step, each step from that step's state."""
    r = _rank0(gloo_job)
    assert r["pattern"] == "model"
    np.testing.assert_allclose(r["losses"]["sharded"], r["losses"]["plain"], rtol=1e-6)
    opt = AdamW(schedule=lambda s: 1e-3)

    def moments(st, leaf):  # bias-corrected m and sqrt(v)
        n = int(st["opt/step"])
        mu, nu = (st[f"opt/{m}/{leaf}"].double() for m in ("mu", "nu"))
        return mu / (1 - opt.b1 ** n), torch.sqrt(nu / (1 - opt.b2 ** n))

    for sharded, plain in zip(r["states"]["sharded"], r["states"]["plain"]):
        off = total = 0
        for k, v in sharded.items():
            d = (v.double() - plain[k].double()).abs()
            over = d > 1e-5
            if bool(over.any()):
                # Only where the gradient lies below Adam's eps in the
                # whole-batch run does m / (sqrt(v) + eps) turn float32
                # rounding (a gradient's sign) into a step of up to lr: there
                # the two runs' own moments must give the difference, to 1e-6.
                assert k.startswith("params/"), k
                leaf = k[len("params/"):]
                (m1, r1), (m0, r0) = moments(sharded, leaf), moments(plain, leaf)
                assert bool((r0[over] < opt.eps).all()), (k, float(d.max()))
                moved = 1e-3 * (m1 / (r1 + opt.eps) - m0 / (r0 + opt.eps))
                left = (v.double() - plain[k].double() + moved).abs()
                assert float(left[over].max()) <= 1e-6, k
            if k.startswith("params/"):
                off += int((d > 1e-6).sum())
                total += v.numel()
        assert off <= 1e-3 * total, f"{off} of {total} parameters off by more than 1e-6"


def test_state_shards_follow_the_rules(gloo_job):
    """On (data 2, model 2), rank 0 holds half of each sharded axis."""
    shapes = _rank0(gloo_job)["shard_shapes"]
    cfg = configs.get_config("zamba2-1.2b", reduced=True)
    rules = ShardingRules(mesh=abstract_mesh((2, 2), ("data", "model")))
    full = dict(_leaves(abstract_train_state(cfg, AdamW(schedule=lambda s: 1e-3))))
    axes = dict(_leaves(train_state_logical_axes(cfg)))
    n_sharded = 0
    for k, (local, placements) in shapes.items():
        spec = rules.spec_for(axes[k], tuple(full[k].shape))
        want = tuple(s // (2 if part else 1) for s, part in zip(full[k].shape, spec))
        assert local == want and placements == placements_for(rules.mesh, spec), k
        n_sharded += any(part is not None for part in spec)
    assert n_sharded > len(shapes) // 2


def test_checkpoint_restores_onto_another_mesh_bitwise(gloo_job):
    r = _rank0(gloo_job)
    assert r["placed_as_rules"]
    for k, v in r["sharded"].items():
        assert torch.equal(r["restored41"][k], v), k
        assert torch.equal(r["unsharded"][k], v), k


def test_compressed_allreduce_codes_match_reference(gloo_job):
    for rank in range(4):
        z = np.load(gloo_job / f"codes{rank}.npz")
        for c, codes, scale in zip(z["corrected"], z["codes"], z["scales"]):
            jcodes, jscale = jcollectives._quantize_block(jax.numpy.asarray(c))
            np.testing.assert_array_equal(codes, np.asarray(jcodes))
            assert scale.tobytes() == np.asarray(jscale, np.float32).tobytes()


def test_compressed_allreduce_error_feedback_converges(gloo_job):
    for rank in range(4):
        bias = float(np.load(gloo_job / f"codes{rank}.npz")["bias"])
        assert bias < 0.01


def test_ring_collective_matmul_equals_the_product(gloo_job):
    for rank in range(4):
        errs = np.load(gloo_job / f"ring{rank}.npy")
        assert errs.shape == (2,) and (errs < 1e-4).all()


def test_kernel_wrappers_refuse_a_dtensor(gloo_job):
    for rank in range(4):
        assert set(np.load(gloo_job / f"refused{rank}.npy")) == {
            "flash_attention", "layernorm", "ssd_scan"}


def test_launch_train_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--arch",
         "mamba2-130m", "--steps", "3", "--batch", "2", "--seq", "32", "--workdir",
         str(tmp_path)], capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "done at step 3" in r.stdout
    assert os.path.isdir(tmp_path / "checkpoints" / "step_00000003")

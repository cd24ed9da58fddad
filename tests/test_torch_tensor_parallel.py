"""The port's split over the model axis (``distributed.tensor_parallel``,
``make_train_step(mesh=, rules=)`` with ``split == "model"``) against its
unsharded step and the JAX package's ``train_step``, on the CPU.

One spawned gloo job of 4 CPU processes (``tests/_torch_tp_worker.py``;
``init_method="file://"`` under ``tmp_path``, so no port is fixed) runs the
reduced granite-8b, granite-moe-3b-a800m, starcoder2-7b (biases, an untied
``lm_head``, a rolling window in decode), minicpm-2b (MHA, muP scales) and
dbrx-132b (LayerNorm, untied) on the (data 2, model 2) and (data 1, model
4) meshes.  At model 4 the two kv heads of granite-8b, starcoder2 and
dbrx do not divide the axis, so K/V's weight comes whole and each rank
projects the kv head its q head uses, and the MoE configs run one expert
per rank.  From the same converted parameters:

- each leaf's split gradient on a rank's rows against the unsharded one
  (the router, the norms and the embedding among them), and the step's
  metrics, ``moe_dropped_frac`` exactly;
- the shapes each rank holds and computes at against ``rules.spec_for``;
- ``lm.forward`` logits and a prefill plus 4 greedy decode steps over
  caches of the local kv heads against the unsharded ones;
- two split steps' losses and states, each step from the state the
  unsharded step starts from, against the unsharded step that averages the
  data shards' microbatches (``grad_accum`` = the data degree), and
  against the JAX package's ``train_step`` from that state (JAX runs here);
- on (data 4, model 1), a group of one: the step takes the unsplit path
  and ``lm.forward`` is bitwise the forward without a group.

States are held to 1e-5: each moment leaf within 1e-5 of its largest
magnitude, each parameter within 1e-5 of max(1, |x|).  Adam divides the
first moment by the root of the second, so where a gradient element is
at the rounding's size its normalised update may move by up to 2 (its sign
flips): such a parameter (at most 1e-3 of them) must differ by exactly
what the two runs' moments give through AdamW, to 1e-6.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import numpy_tree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp_lib  # noqa: E402
from repro_torch.distributed.sharding import ShardingRules  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import params as params_lib  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("granite-8b", "granite-moe-3b-a800m", "starcoder2-7b", "minicpm-2b", "dbrx-132b")
MESHES = ((2, 2), (1, 4))
CASES = [(a, m) for a in ARCHS for m in MESHES]
BATCH, SEQ, STEPS, LR = 4, 16, 2, 1e-3
TOL = 1e-5
ADAM_RESIDUAL = 1e-6  # of max(1, |x|): a parameter's difference not explained by the moments


def _ids(case):
    arch, (d, m) = case
    return f"{arch}@{d}x{m}"


def _inputs():
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = jax_get_config(arch, reduced=True)
        rng = np.random.default_rng(100 + i)
        out[arch] = {"params": numpy_tree(jlm.param_spec(jcfg), seed=10 + i),
                     "batches": [rng.integers(0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
                                 for _ in range(STEPS)]}
    return out


@pytest.fixture(scope="module")
def tp_job(tmp_path_factory):
    """Spawn the 4-process job once; (inputs, each rank's results)."""
    out = tmp_path_factory.mktemp("tp")
    inputs = _inputs()
    torch.save(inputs, out / "inputs.pt")
    code = ("import sys, torch.multiprocessing as mp; sys.path.insert(0, sys.argv[2]); "
            "import _torch_tp_worker as w; "
            "mp.spawn(w.run, args=(4, sys.argv[1]), nprocs=4, join=True)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code, str(out), os.path.join(ROOT, "tests")],
                       capture_output=True, text=True, env=env, timeout=240)
    assert r.returncode == 0, r.stderr[-4000:]
    ranks = [torch.load(out / f"tp{k}.pt", weights_only=False) for k in range(4)]
    return inputs, ranks


def _key(arch, mesh):
    return f"{arch}@{mesh[0]}x{mesh[1]}"


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree) for k2, v2 in _flat(tree[k], path + (k,)).items()}
    return {"/".join(path): tree}


def _nest(flat: dict) -> dict:
    out = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _adam_update(mu, nu, step: int):
    """AdamW's normalised update m / sqrt(v) (bias-corrected) at ``step``,
    in float64."""
    opt = JAdamW(schedule=lambda s: LR)
    c1, c2 = 1 - opt.b1 ** step, 1 - opt.b2 ** step
    return (mu / c1) / (np.sqrt(nu / c2) + opt.eps)


def _hold_state(got: dict, want: dict):
    """One step's states (flat, from one state): the step counts equal;
    each moment leaf within ``TOL`` of its largest magnitude; each parameter
    within ``TOL`` of max(1, |x|) or, at most 1e-3 of them, where Adam's
    normalised update amplifies rounding, off by exactly what the two
    runs' moments give through AdamW (the rest within ``ADAM_RESIDUAL``)."""
    f64 = {k: np.asarray(v, np.float64) for k, v in want.items()}
    g64 = {k: np.asarray(v, np.float64) for k, v in got.items()}
    step = int(want["opt/step"])
    assert int(got["opt/step"]) == step
    off = total = 0
    for k in (k for k in want if k.startswith("params/")):
        leaf = k[len("params/"):]
        for m in ("mu", "nu"):
            w, g = f64[f"opt/{m}/{leaf}"], g64[f"opt/{m}/{leaf}"]
            err = float(np.abs(g - w).max())
            assert err <= TOL * max(float(np.abs(w).max()), 1e-30), (m, leaf, err)
        d = np.abs(g64[k] - f64[k]) / np.maximum(1.0, np.abs(f64[k]))
        over = d > TOL
        if over.any():
            moved = LR * (_adam_update(g64[f"opt/mu/{leaf}"], g64[f"opt/nu/{leaf}"], step)
                          - _adam_update(f64[f"opt/mu/{leaf}"], f64[f"opt/nu/{leaf}"], step))
            left = np.abs(g64[k] - f64[k] + moved) / np.maximum(1.0, np.abs(f64[k]))
            assert float(left[over].max()) <= ADAM_RESIDUAL, (leaf, float(left[over].max()))
        off += int(over.sum())
        total += d.size
    assert off <= 1e-3 * total, f"{off} of {total} parameters off by more than {TOL}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_split_step_equals_the_unsharded_step(tp_job, case):
    _, ranks = tp_job
    arch, mesh = case
    r = ranks[0][_key(arch, mesh)]
    assert r["split"] == "model" and len(r["steps"]) == STEPS
    for st in r["steps"]:
        assert abs(st["loss"]["split"] - st["loss"]["plain"]) <= TOL
        _hold_state({k: v.numpy() for k, v in st["split"].items()},
                    {k: v.numpy() for k, v in st["plain"].items()})
    for other in ranks[1:]:  # every rank holds the same state and losses
        o = other[_key(arch, mesh)]
        for st, ot in zip(r["steps"], o["steps"]):
            assert ot["loss"] == st["loss"]
            assert all(torch.equal(v, st["split"][k]) for k, v in ot["split"].items())


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_split_step_tracks_the_reference_train_step(tp_job, case):
    """Each split step against ``repro.train.step.train_step`` from the same
    state and batch, its ``grad_accum`` the data degree."""
    inputs, ranks = tp_job
    arch, mesh = case
    jcfg = jax_get_config(arch, reduced=True)
    jopt = JAdamW(schedule=lambda s: LR)
    fn = jax.jit(lambda st, b: jstep.train_step(st, {"tokens": b}, cfg=jcfg, optimizer=jopt,
                                                grad_accum=mesh[0]))
    r = ranks[0][_key(arch, mesh)]
    for st, b in zip(r["steps"], inputs[arch]["batches"]):
        before = _nest({k: jnp.asarray(v.numpy()) for k, v in st["before"].items()})
        state, m = fn(before, jnp.asarray(b))
        assert abs(st["loss"]["split"] - float(m["loss"])) <= TOL
        ref = {f"params/{k}": np.asarray(v) for k, v in _flat(state["params"]).items()}
        ref.update({f"opt/{k}": np.asarray(v) for k, v in _flat(state["opt"]).items()})
        _hold_state({k: v.numpy() for k, v in st["split"].items()}, ref)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_split_gradients_equal_the_unsharded_gradients(tp_job, case):
    """On each rank's rows: every leaf's gradient (its model shard, or the
    whole leaf where the split takes it whole) within 1e-5 of the unsharded
    one, the router's, the norms' and the embedding's among them; the
    metrics too, the dropped share exactly."""
    _, ranks = tp_job
    arch, mesh = case
    for rank in ranks:
        r = rank[_key(arch, mesh)]
        named = [k for k in r["grad_errs"] if any(
            s in k for s in ("router", "ln1", "ln2", "final_norm", "embed"))]
        assert len(named) >= (5 if configs.get_config(arch).moe else 4)
        for k, err in r["grad_errs"].items():
            assert err <= TOL, (k, err)
        for k, err in r["metric_errs"].items():
            assert abs(err) <= (0.0 if k == "moe_dropped_frac" else TOL), (k, err)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_each_rank_holds_and_computes_its_shards(tp_job, case):
    """Held: the rules' shard of every leaf.  Computed: its model shard
    where the split takes one (gathered over the data axes only), the whole
    leaf where it does not (K/V when the kv heads do not divide the axis)."""
    _, ranks = tp_job
    arch, (n_data, n_model) = case
    cfg = configs.get_config(arch, reduced=True)
    rules = ShardingRules(mesh=abstract_mesh((n_data, n_model), ("data", "model")))
    spec_tree = lm.param_spec(cfg)
    full = _flat(params_lib.abstract_params(spec_tree))
    axes = _flat(params_lib.logical_axes(spec_tree))
    for rank in ranks:
        r = rank[_key(arch, (n_data, n_model))]
        for k, t in full.items():
            spec = rules.spec_for(axes[k], tuple(t.shape))
            size = {"data": n_data, "model": n_model}
            held = tuple(s // (size[p] if p else 1) for s, p in zip(t.shape, spec))
            assert r["held_shapes"][k] == held, k
            shape, local = r["compute_shapes"][k]
            assert local == tp_lib.takes_model_shard(cfg, axes[k], spec, n_model), k
            want = tuple(s // (n_model if local and p == "model" else 1)
                         for s, p in zip(t.shape, spec))
            assert shape == want, k
    kv = rules.spec_for(axes["blocks/attn/wk/kernel"], tuple(full["blocks/attn/wk/kernel"].shape))
    whole_kv = cfg.n_kv_heads % n_model != 0
    assert kv[-1] == "model"  # the rules split K/V's columns either way
    assert ranks[0][_key(arch, (n_data, n_model))]["compute_shapes"][
        "blocks/attn/wk/kernel"][1] == (not whole_kv)
    if cfg.moe is not None:
        experts = ranks[0][_key(arch, (n_data, n_model))]["compute_shapes"]["blocks/ffn/w_up"][0]
        assert experts[1] == cfg.moe.n_experts // n_model


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_split_forward_prefill_and_decode_equal_the_unsharded(tp_job, case):
    _, ranks = tp_job
    arch, mesh = case
    cfg = configs.get_config(arch, reduced=True)
    for rank in ranks:
        s = rank[_key(arch, mesh)]["serve"]
        assert s["logits_err"] <= TOL
        assert max(s["decode_errs"]) <= TOL
        assert torch.equal(s["split_tokens"], s["whole_tokens"])
        heads = max(1, cfg.n_kv_heads // mesh[1])  # the caches hold the local kv heads
        assert s["cache_heads"] == s["cache_stays_local"] == heads


def test_collectives_are_counted(tp_job):
    """Each split step counts its model-axis collectives: all-reduces of
    partial sums and gradients, gathers of router logits and predictions."""
    _, ranks = tp_job
    for arch, mesh in CASES:
        b = ranks[0][_key(arch, mesh)]["collective_bytes"]
        assert b["all-reduce"] > 0 and b["all-gather"] > 0


def test_a_group_of_one_leaves_the_old_path(tp_job):
    _, ranks = tp_job
    for rank in ranks:
        one = rank["one"]
        assert one["group_size"] == 1 and one["step_group"] is None and one["split"] == "repeat"
        assert one["forward_equal"] and one["loss_equal"]
        assert one["state_close"] <= TOL


def test_unsplit_families_refuse_a_model_group():
    """The SSM family (and MLA, the encoder, the VLM) keep the repeat
    pattern: ``lm.forward`` refuses a group of two; int8 weights too."""
    import dataclasses

    cfg = configs.get_config("mamba2-130m", reduced=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    group = tp_lib.ModelGroup(2, 0)
    with pytest.raises(NotImplementedError, match="item 11"):
        lm.forward(params, cfg, {"tokens": torch.zeros(1, 4, dtype=torch.int32)},
                   device="cpu", group=group)
    dense = dataclasses.replace(configs.get_config("granite-8b", reduced=True),
                                precision="int8_serve")
    params = lm.init_params(dense, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        lm.forward(params, dense, {"tokens": torch.zeros(1, 4, dtype=torch.int32)},
                   device="cpu", group=group)


@pytest.mark.parametrize("name,size,heads", [
    ("granite-8b", 2, (True, (0, 4))), ("granite-8b", 16, (True, (0, 1))),
    ("dbrx-132b", 16, (True, (0, 1))), ("granite-moe-3b-a800m", 16, (False, None)),
    ("starcoder2-7b", 4, (True, (0, 1))), ("minicpm-2b", 16, (False, None))])
def test_heads_split_and_kv_head_ranges(name, size, heads):
    """Which published configs split attention by whole heads on a model
    axis, and rank 0's kv heads."""
    cfg = configs.get_config(name)
    split, rng = heads
    assert tp_lib.heads_split(cfg, size) == split
    if split:
        assert tp_lib.kv_head_range(cfg, tp_lib.ModelGroup(size, 0)) == rng
        last = tp_lib.kv_head_range(cfg, tp_lib.ModelGroup(size, size - 1))
        assert last[1] == cfg.n_kv_heads


@pytest.mark.parametrize("name,size,want", [
    ("granite-8b", 2, tp_lib.Layout(heads=True, kv_heads=True, mlp=True, vocab=True)),
    ("granite-8b", 16, tp_lib.Layout(heads=True, mlp=True, vocab=True)),
    ("dbrx-132b", 16, tp_lib.Layout(heads=True, router=True, experts="experts", vocab=True)),
    ("granite-moe-3b-a800m", 2, tp_lib.Layout(heads=True, kv_heads=True, router=True,
                                              experts="experts", vocab=True)),
    ("granite-moe-3b-a800m", 16, tp_lib.Layout(experts="mlp", vocab=True)),
    ("minicpm-2b", 16, tp_lib.Layout(mlp=True, vocab=True))])
def test_split_plan_layouts_of_published_configs(name, size, want):
    """The layout that ``split_plan`` derives from the rules' specs on a
    (16, ``size``) mesh: K/V whole where the kv heads do not divide the
    axis, q heads that do not split evenly repeated, granite-moe's 40
    experts split by ``mlp`` on 16."""
    cfg = configs.get_config(name)
    spec_tree = lm.param_spec(cfg)
    axes = params_lib.logical_axes(spec_tree)
    rules = ShardingRules(mesh=abstract_mesh((16, size), ("data", "model")))
    shardings = rules.tree_shardings(params_lib.abstract_params(spec_tree), axes)
    layout, local = tp_lib.split_plan(cfg, axes, shardings, size)
    assert layout == want
    assert local["blocks"]["attn"]["wk"]["kernel"] == want.kv_heads  # else gathered whole

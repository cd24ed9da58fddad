"""The port's split over the model axis (``distributed.tensor_parallel``,
``make_train_step(mesh=, rules=)`` with ``split == "model"``) against its
unsharded step and the JAX package's ``train_step``, on the CPU.

One spawned gloo job of 4 CPU processes (``tests/_torch_tp_worker.py``;
``init_method="file://"`` under ``tmp_path``, so no port is fixed) runs the
reduced granite-8b, granite-moe-3b-a800m, starcoder2-7b (biases, an untied
``lm_head``, a rolling window in decode), minicpm-2b (MHA, muP scales),
dbrx-132b (LayerNorm, untied), minicpm3-4b (MLA), mamba2-130m (Mamba2),
zamba2-1.2b (Mamba2 and the shared attention block), hubert-xlarge (the
audio encoder: frames and labels, bidirectional, its vocabulary in
``lm_head``), internvl2-1b (the VLM: patches before the tokens) and
granite-8b under ``int8_serve`` (its weights the plan's transform of the
whole leaves, int8 KV caches, the LUT softmax) on the (data 2, model 2) and
(data 1, model 4) meshes.  At model 4 the two kv heads of
granite-8b, starcoder2 and dbrx do not divide the axis, so K/V's weight
comes whole and each rank projects the kv head its q head uses, and the
MoE configs run one expert per rank; the MLA, Mamba2, hybrid, encoder and
VLM cases split their heads on both meshes (internvl2-1b's two kv heads
come whole at model 4).  From the same converted parameters:

- each leaf's split gradient on a rank's rows, averaged over the data
  axis as the step averages it, against the unsharded gradient of the
  whole batch (the router, the norms and the embedding among them), and
  the step's metrics, ``moe_dropped_frac`` exactly;
- the shapes each rank holds and computes at against ``rules.spec_for``;
- ``lm.forward`` logits and (not for the encoder) a prefill plus 4 greedy
  decode steps over caches of the local kv heads / SSM heads against the
  unsharded ones; for MLA also an absorbed decode step and a 4-token
  extend window;
- two split steps' losses and states, each step from the state the
  unsharded step starts from, against the unsharded step on the whole
  batch, and against the JAX package's ``train_step`` (``grad_accum=1``)
  from that state (JAX runs here);
- a data-sharded MoE step whose capacity binds (reduced granite-moe at a
  capacity factor of 0.75) on (data 2, model 1) and (data 2, model 2),
  and a ``loss_mask`` whose data shards hold unequal sums (granite-8b on
  (data 2, model 2)), against the whole-batch step and JAX's;
- on (data 4, model 1), a group of one: the step takes the unsplit path
  and ``lm.forward`` is bitwise the forward without a group.

States are held to 1e-5: each moment leaf within 1e-5 of its largest
magnitude, each parameter within 1e-5 of max(1, |x|).  Reduced
zamba2-1.2b sits at float32's floor for that scheme whatever the split:
its unsharded step and JAX's step are themselves 2.3e-5 apart (moments, of
their leaf's largest magnitude, step 1).  Its split and unsharded float32
runs are each 0.7-1.4e-5 of the leaf's largest gradient off the same
unsharded run with its parameters in float64, and at most 1.6e-5 from one
another (the embedding's gradient, (1, 4)); between them the logits read
1.0e-5 apart, the moments 2.4e-5 of their leaf's largest magnitude and the
parameters 1.3e-5 of max(1, |x|).  Its cases (gradients, states, logits,
against the unsharded step and JAX's) are held to 5e-5 (``TOL_OF``).
Adam divides the first moment by the root of the second, so where a
gradient element is at the rounding's size its normalised update may move
by up to 2 (its sign flips): such a parameter (at most 1e-3 of them) must
differ by exactly what the two runs' moments give through AdamW, to 1e-6.
"""

import dataclasses
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
from repro_torch.core import precision as precision_lib  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp_lib  # noqa: E402
from repro_torch.distributed.sharding import ShardingRules  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import params as params_lib  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a case is an architecture, or "<architecture>:<precision policy>"
ARCHS = ("granite-8b", "granite-moe-3b-a800m", "starcoder2-7b", "minicpm-2b", "dbrx-132b",
         "minicpm3-4b", "mamba2-130m", "zamba2-1.2b", "hubert-xlarge", "internvl2-1b",
         "granite-8b:int8_serve")
#: the cases whose heads split on both meshes (their reduced configs' 4 or 8
#: heads divide both model axes)
SPLIT_HEADS = ("minicpm3-4b", "mamba2-130m", "zamba2-1.2b", "hubert-xlarge", "internvl2-1b")
MESHES = ((2, 2), (1, 4))
CASES = [(a, m) for a in ARCHS for m in MESHES]
MOE_CF = 0.75  # the whole-batch MoE cases' capacity factor (the worker's)
MOE_MESHES = ("2x1", "2x2")
BATCH, SEQ, STEPS, LR = 4, 16, 2, 1e-3
TOL = 1e-5
TOL_OF = {"zamba2-1.2b": 5e-5}  # float32's floor for the reduced config (module docstring)
ADAM_RESIDUAL = 1e-6  # of max(1, |x|): a parameter's difference not explained by the moments


def _ids(case):
    arch, (d, m) = case
    return f"{arch}@{d}x{m}"


def _jax_config(name):
    """The JAX package's reduced config of a case name (``ARCHS``)."""
    arch, _, policy = name.partition(":")
    jcfg = jax_get_config(arch, reduced=True)
    return dataclasses.replace(jcfg, precision=policy) if policy else jcfg


def _batch(jcfg, rng):
    """One batch of the config's family: frames and labels (the audio
    encoder), patches before ``SEQ`` tokens (the VLM), or tokens."""
    if jcfg.frontend == "audio":
        return {"frames": rng.normal(size=(BATCH, SEQ, jcfg.frontend_dim)).astype(np.float32),
                "labels": rng.integers(0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)}
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)}
    if jcfg.frontend == "patch":
        batch["patches"] = rng.normal(size=(BATCH, jcfg.n_frontend_tokens,
                                            jcfg.frontend_dim)).astype(np.float32)
    return batch


def _inputs():
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = _jax_config(arch)
        rng = np.random.default_rng(100 + i)
        out[arch] = {"params": numpy_tree(jlm.param_spec(jcfg), seed=10 + i),
                     "batches": [_batch(jcfg, rng) for _ in range(STEPS)]}
    # the masked case's loss_mask: the first data shard (rows 0-1) keeps 5
    # of its 32 positions, the second 27
    mask = np.ones((BATCH, SEQ), np.float32)
    mask[0, 3:] = 0.0
    mask[1, :] = 0.0
    mask[1, 4:6] = 1.0
    mask[3, 11:] = 0.0
    out["granite-8b"]["mask"] = mask
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
                       capture_output=True, text=True, env=env, timeout=400)
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


def _config(name: str, reduced: bool = True):
    """The port's config of a case name (``ARCHS``)."""
    arch, _, policy = name.partition(":")
    cfg = configs.get_config(arch, reduced=reduced)
    return dataclasses.replace(cfg, precision=policy) if policy else cfg


def _tol(arch: str) -> float:
    return TOL_OF.get(arch, TOL)


def _hold_state(got: dict, want: dict, tol: float = TOL):
    """One step's states (flat, from one state): the step counts equal;
    each moment leaf within ``tol`` of its largest magnitude; each parameter
    within ``tol`` of max(1, |x|) or, at most 1e-3 of them, where Adam's
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
            assert err <= tol * max(float(np.abs(w).max()), 1e-30), (m, leaf, err)
        d = np.abs(g64[k] - f64[k]) / np.maximum(1.0, np.abs(f64[k]))
        over = d > tol
        if over.any():
            moved = LR * (_adam_update(g64[f"opt/mu/{leaf}"], g64[f"opt/nu/{leaf}"], step)
                          - _adam_update(f64[f"opt/mu/{leaf}"], f64[f"opt/nu/{leaf}"], step))
            left = np.abs(g64[k] - f64[k] + moved) / np.maximum(1.0, np.abs(f64[k]))
            assert float(left[over].max()) <= ADAM_RESIDUAL, (leaf, float(left[over].max()))
        off += int(over.sum())
        total += d.size
    assert off <= 1e-3 * total, f"{off} of {total} parameters off by more than {tol}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_split_step_equals_the_unsharded_step(tp_job, case):
    _, ranks = tp_job
    arch, mesh = case
    r = ranks[0][_key(arch, mesh)]
    assert r["split"] == "model" and len(r["steps"]) == STEPS
    for st in r["steps"]:
        assert abs(st["loss"]["split"] - st["loss"]["plain"]) <= TOL
        _hold_state({k: v.numpy() for k, v in st["split"].items()},
                    {k: v.numpy() for k, v in st["plain"].items()}, _tol(arch))
    for other in ranks[1:]:  # every rank holds the same state and losses
        o = other[_key(arch, mesh)]
        for st, ot in zip(r["steps"], o["steps"]):
            assert ot["loss"] == st["loss"]
            assert all(torch.equal(v, st["split"][k]) for k, v in ot["split"].items())


def _jax_steps(jcfg, steps, batches):
    """``repro.train.step.train_step`` (``grad_accum=1``, the whole batch)
    from each recorded step's state: (its state flat as the worker's, its
    metrics) per step."""
    jopt = JAdamW(schedule=lambda s: LR)
    fn = jax.jit(lambda st, b: jstep.train_step(st, b, cfg=jcfg, optimizer=jopt))
    out = []
    for st, b in zip(steps, batches):
        before = _nest({k: jnp.asarray(v.numpy()) for k, v in st["before"].items()})
        state, m = fn(before, {k: jnp.asarray(v) for k, v in b.items()})
        ref = {f"params/{k}": np.asarray(v) for k, v in _flat(state["params"]).items()}
        ref.update({f"opt/{k}": np.asarray(v) for k, v in _flat(state["opt"]).items()})
        out.append((ref, {k: float(v) for k, v in m.items()}))
    return out


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_split_step_tracks_the_reference_train_step(tp_job, case):
    """Each split step against ``repro.train.step.train_step`` from the same
    state on the whole batch (``grad_accum=1``), as the reference's sharded
    step is that step jitted over the global batch."""
    inputs, ranks = tp_job
    arch, mesh = case
    r = ranks[0][_key(arch, mesh)]
    for st, (ref, m) in zip(r["steps"], _jax_steps(_jax_config(arch), r["steps"],
                                                    inputs[arch]["batches"])):
        assert abs(st["loss"]["split"] - m["loss"]) <= TOL
        _hold_state({k: v.numpy() for k, v in st["split"].items()}, ref, _tol(arch))


@pytest.mark.parametrize("arch", SPLIT_HEADS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_mla_ssm_hybrid_encoder_and_vlm_really_split_their_heads(tp_job, arch, mesh):
    """The MLA, Mamba2, hybrid, audio encoder and VLM cases take the
    ``"model"`` pattern with a layout that splits their heads, so no case
    passes on a repeated layer; the encoder's vocabulary splits through
    ``lm_head`` (it has no table), and ``frontend_proj`` is computed whole,
    as ``takes_model_shard`` says of its ``("frontend", "embed")`` axes."""
    _, ranks = tp_job
    cfg = _config(arch)
    for rank in ranks:
        r = rank[_key(arch, mesh)]
        assert r["split"] == "model"
        layout = r["layout"]
        assert layout["vocab"]
        if cfg.attn_kind == "mla":
            assert layout["heads"] and layout["mlp"]
        if cfg.ssm is not None:
            assert layout["ssm"]
        if cfg.family == "hybrid":
            assert layout["heads"] and layout["kv_heads"] and layout["mlp"]
            assert layout["shared_out"]
        if cfg.frontend is not None:
            assert layout["heads"] and layout["mlp"]
            assert layout["kv_heads"] == (cfg.n_kv_heads % mesh[1] == 0)
            shape, local = r["compute_shapes"]["frontend_proj/kernel"]
            assert local and shape == (cfg.frontend_dim, cfg.d_model)


def _moe_cfgs():
    jcfg = jax_get_config("granite-moe-3b-a800m", reduced=True)
    return dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=MOE_CF))


@pytest.mark.parametrize("mesh", MOE_MESHES)
def test_data_sharded_moe_step_is_the_whole_batch_step(tp_job, mesh):
    """A data-sharded MoE step whose capacity binds, on (data 2, model 1)
    (the ``"repeat"`` pattern) and (data 2, model 2) (``"model"``), against
    the unsharded step and JAX's ``train_step`` on the whole batch: loss,
    aux loss and state within the file's tolerances, the dropped share
    exactly.  Sized per data shard, the capacity, the drops and the aux
    loss's means would be each shard's."""
    inputs, ranks = tp_job
    jcfg = _moe_cfgs()
    r = ranks[0]["moe_whole_batch"][mesh]
    assert r["split"] == ("repeat" if mesh == "2x1" else "model")
    jax_steps = _jax_steps(jcfg, r["steps"], inputs["granite-moe-3b-a800m"]["batches"])
    for st, (ref, m) in zip(r["steps"], jax_steps):
        got, plain = st["metrics"]["split"], st["metrics"]["plain"]
        assert 0 < m["moe_dropped_frac"] < 1  # capacity binds
        assert got["moe_dropped_frac"] == plain["moe_dropped_frac"] == m["moe_dropped_frac"]
        for k in ("loss", "moe_aux_loss", "moe_z_loss", "ce_loss"):
            assert abs(got[k] - plain[k]) <= TOL, (k, got[k], plain[k])
            assert abs(got[k] - m[k]) <= TOL, (k, got[k], m[k])
        _hold_state({k: v.numpy() for k, v in st["split"].items()},
                    {k: v.numpy() for k, v in st["plain"].items()})
        _hold_state({k: v.numpy() for k, v in st["split"].items()}, ref)
    for other in ranks[1:]:  # every rank holds the same state and metrics
        for st, ot in zip(r["steps"], other["moe_whole_batch"][mesh]["steps"]):
            assert ot["metrics"]["split"] == st["metrics"]["split"]


def test_loss_mask_with_unequal_shards_is_the_whole_batch_mean(tp_job):
    """A ``loss_mask`` whose data shards hold 5 and 27 of the positions:
    the split step divides by the whole batch's mask, so its loss and state
    are the whole-batch step's and JAX's (the mean of the shards' own
    masked means would weigh the shards alike)."""
    inputs, ranks = tp_job
    r = ranks[0]["masked"]
    assert r["split"] == "model"
    mask = inputs["granite-8b"]["mask"]
    assert mask[:2, 1:].sum() != mask[2:, 1:].sum()
    batches = [dict(b, loss_mask=mask) for b in inputs["granite-8b"]["batches"]]
    for st, (ref, m) in zip(r["steps"], _jax_steps(jax_get_config("granite-8b", reduced=True),
                                                    r["steps"], batches)):
        got, plain = st["metrics"]["split"], st["metrics"]["plain"]
        for k in ("loss", "accuracy"):
            assert abs(got[k] - plain[k]) <= TOL and abs(got[k] - m[k]) <= TOL, k
        _hold_state({k: v.numpy() for k, v in st["split"].items()},
                    {k: v.numpy() for k, v in st["plain"].items()})
        _hold_state({k: v.numpy() for k, v in st["split"].items()}, ref)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_split_gradients_equal_the_unsharded_gradients(tp_job, case):
    """Each rank's gradient on its rows, averaged over the data axis:
    every leaf's (its model shard, or the whole leaf where the split takes
    it whole) within 1e-5 of the unsharded gradient of the whole batch, the
    router's, the norms' and the embedding's among them; the metrics too,
    the dropped share exactly."""
    _, ranks = tp_job
    arch, mesh = case
    for rank in ranks:
        r = rank[_key(arch, mesh)]
        named = [k for k in r["grad_errs"] if any(
            s in k for s in ("router", "ln1", "ln2", "final_norm", "embed"))]
        cfg = _config(arch, reduced=False)
        assert len(named) >= (5 if cfg.moe else 3 if cfg.family == "ssm" else 4)  # no ln2
        for k, err in r["grad_errs"].items():
            assert err <= _tol(arch), (k, err)
        for k, err in r["metric_errs"].items():
            assert abs(err) <= (0.0 if k == "moe_dropped_frac" else TOL), (k, err)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_each_rank_holds_and_computes_its_shards(tp_job, case):
    """Held: the rules' shard of every leaf.  Computed: its model shard
    where the split takes one (gathered over the data axes only), the whole
    leaf where it does not (K/V when the kv heads do not divide the axis)."""
    _, ranks = tp_job
    arch, (n_data, n_model) = case
    cfg = _config(arch)
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
    computed = ranks[0][_key(arch, (n_data, n_model))]["compute_shapes"]
    wk = "shared_attn/attn/wk/kernel" if cfg.family == "hybrid" else "blocks/attn/wk/kernel"
    if wk in full:
        kv = rules.spec_for(axes[wk], tuple(full[wk].shape))
        whole_kv = cfg.n_kv_heads % n_model != 0
        assert kv[-1] == "model"  # the rules split K/V's columns either way
        assert computed[wk][1] == (not whole_kv)
    if cfg.moe is not None:
        assert computed["blocks/ffn/w_up"][0][1] == cfg.moe.n_experts // n_model
    if cfg.attn_kind == "mla":  # the lora leaves whole, wo's rows split by heads
        for k in ("wq_a", "wkv_a", "wq_b", "wk_b", "wv_b"):
            assert computed[f"blocks/attn/{k}/kernel"] == (tuple(full[
                f"blocks/attn/{k}/kernel"].shape), False), k
        assert computed["blocks/attn/wo/kernel"][1]
    if cfg.ssm is not None:  # the packed leaves whole, out_proj's rows split by heads
        for k in ("in_proj/kernel", "conv_w", "conv_b"):
            assert computed[f"blocks/mamba/{k}"] == (tuple(full[f"blocks/mamba/{k}"].shape),
                                                     False), k
        assert computed["blocks/mamba/out_proj/kernel"][1]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_split_forward_prefill_and_decode_equal_the_unsharded(tp_job, case):
    """The split forward's logits, and a prefill plus 4 greedy decode steps
    (not for the encoder, which has no decode step; the VLM's prefill
    takes its patches), against the unsplit ones; under ``int8_serve`` on
    the plan's whole-leaf weights cut after the transform, over int8 KV
    caches narrowed by kv head (codes and scales), with the LUT softmax."""
    _, ranks = tp_job
    arch, mesh = case
    cfg = _config(arch)
    for rank in ranks:
        s = rank[_key(arch, mesh)]["serve"]
        assert s["logits_err"] <= _tol(arch)
        assert torch.equal(s["split_tokens"], s["whole_tokens"])
        if cfg.is_encoder:
            assert s["decode_errs"] == [] and s["cache_shapes"] == {}
            continue
        assert len(s["decode_errs"]) == 5 and max(s["decode_errs"]) <= _tol(arch)
        shapes = s["cache_shapes"]
        assert s["cache_stays_local"] == shapes
        if cfg.precision == "int8_serve":  # int8 codes, one scale per (token, local kv head)
            kv = max(1, cfg.n_kv_heads // mesh[1])
            assert shapes["layers/k_scale"][2] == shapes["layers/v_scale"][2] == kv
        if cfg.attn_kind == "gqa":  # the caches hold the local kv heads
            k = "shared/k" if cfg.family == "hybrid" else "layers/k"
            assert shapes[k][2] == max(1, cfg.n_kv_heads // mesh[1])
        if cfg.attn_kind == "mla":  # the latent is the heads', whole
            m = cfg.mla
            assert shapes["layers/latent"][-1] == m.kv_lora_rank + m.qk_rope_head_dim
            # the absorbed decode and an extend window at the local heads
            assert s["absorbed_decode_err"] <= TOL and s["extend_err"] <= TOL
        if cfg.ssm is not None:  # the local SSM heads, their x and the whole B / C
            sc = cfg.ssm
            h = sc.n_heads(cfg.d_model) // mesh[1]
            assert shapes["layers/ssm_state"][2] == h
            assert shapes["layers/conv_state"][-1] == h * sc.head_dim + 2 * sc.state_dim


def test_collectives_are_counted(tp_job):
    """Each split step counts its model-axis collectives: all-reduces of
    partial sums and gradients, gathers of router logits and predictions."""
    _, ranks = tp_job
    for arch, mesh in CASES:
        b = ranks[0][_key(arch, mesh)]["collective_bytes"]
        assert b["all-reduce"] > 0 and b["all-gather"] > 0


def test_a_group_of_one_leaves_the_old_path(tp_job):
    """(data 4, model 1): the ``"repeat"`` step, within float32 rounding of
    the whole-batch step (its MoE layers the whole batch's: the dropped
    share exact); a group of one leaves ``lm.forward`` bitwise as it was."""
    _, ranks = tp_job
    for rank in ranks:
        one = rank["one"]
        assert one["group_size"] == 1 and one["step_group"] is None and one["split"] == "repeat"
        assert one["forward_equal"] and one["dropped_equal"]
        assert one["loss_err"] <= TOL
        assert one["state_close"] <= TOL


@pytest.mark.parametrize("size", [2, 16])
def test_vocab_padding_mask_on_each_rank_of_hubert(size):
    """hubert-xlarge's 504 units pad to 512: on a model axis of 2 and of 16
    each rank's shard of the logits masks exactly its columns at global
    index 504 or above (on 16, only the last rank's top 8)."""
    cfg = configs.get_config("hubert-xlarge")
    assert (cfg.vocab_size, cfg.padded_vocab_size) == (504, 512)
    n = cfg.padded_vocab_size // size
    parts = [lm.mask_vocab_padding(torch.zeros(1, 1, n), cfg, tp_lib.ModelGroup(size, r))
             for r in range(size)]
    masked = (torch.cat(parts, -1)[0, 0] == -1e9).nonzero()[:, 0]
    assert masked.tolist() == list(range(504, 512))
    assert all(not (p == -1e9).any() for p in parts[:-1])


def test_every_family_and_int8_plans_split():
    """``splits`` takes every family of the zoo, and ``require_split``
    refuses neither the encoder, the VLM nor an ``int8_serve`` plan."""
    for name in configs.ARCH_NAMES:
        cfg = configs.get_config(name)
        assert tp_lib.splits(cfg), name
        tp_lib.require_split(cfg)
    dense = dataclasses.replace(configs.get_config("granite-8b"), precision="int8_serve")
    tp_lib.require_split(dense, precision_lib.resolve_model_plan(dense))


@pytest.mark.parametrize("name,size,heads", [
    ("granite-8b", 2, (True, (0, 4))), ("granite-8b", 16, (True, (0, 1))),
    ("dbrx-132b", 16, (True, (0, 1))), ("granite-moe-3b-a800m", 16, (False, None)),
    ("starcoder2-7b", 4, (True, (0, 1))), ("minicpm-2b", 16, (False, None)),
    ("minicpm3-4b", 2, (True, (0, 20))), ("minicpm3-4b", 16, (False, None)),
    ("zamba2-1.2b", 16, (True, (0, 2))), ("hubert-xlarge", 2, (True, (0, 8))),
    ("hubert-xlarge", 16, (True, (0, 1))), ("internvl2-1b", 2, (True, (0, 1))),
    ("internvl2-1b", 16, (False, None))])
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
    ("minicpm-2b", 16, tp_lib.Layout(mlp=True, vocab=True)),
    ("minicpm3-4b", 2, tp_lib.Layout(heads=True, mlp=True, vocab=True)),
    ("minicpm3-4b", 16, tp_lib.Layout(mlp=True, vocab=True)),
    ("mamba2-130m", 2, tp_lib.Layout(vocab=True, ssm=True)),
    ("mamba2-130m", 16, tp_lib.Layout(vocab=True)),
    ("zamba2-1.2b", 16, tp_lib.Layout(heads=True, kv_heads=True, mlp=True, vocab=True, ssm=True,
                                      shared_out=True)),
    ("hubert-xlarge", 2, tp_lib.Layout(heads=True, kv_heads=True, mlp=True, vocab=True)),
    ("hubert-xlarge", 16, tp_lib.Layout(heads=True, kv_heads=True, mlp=True, vocab=True)),
    ("internvl2-1b", 2, tp_lib.Layout(heads=True, kv_heads=True, mlp=True, vocab=True)),
    ("internvl2-1b", 16, tp_lib.Layout(mlp=True, vocab=True))])
def test_split_plan_layouts_of_published_configs(name, size, want):
    """The layout that ``split_plan`` derives from the rules' specs on a
    (16, ``size``) mesh: K/V whole where the kv heads do not divide the
    axis, q heads that do not split evenly repeated, granite-moe's 40
    experts split by ``mlp`` on 16; minicpm3-4b's 40 heads and
    mamba2-130m's 24 SSM heads repeat on 16, zamba2-1.2b's 64 SSM heads and
    32 shared-block heads split; hubert-xlarge's 16 heads split on both
    (its vocabulary through ``lm_head``, having no table), internvl2-1b's
    14 split on 2 (7 q heads and one kv head a rank) and repeat on 16, the
    MLP and vocabulary splitting; ``frontend_proj`` is whole."""
    cfg = configs.get_config(name)
    spec_tree = lm.param_spec(cfg)
    axes = params_lib.logical_axes(spec_tree)
    rules = ShardingRules(mesh=abstract_mesh((16, size), ("data", "model")))
    shardings = rules.tree_shardings(params_lib.abstract_params(spec_tree), axes)
    layout, local = tp_lib.split_plan(cfg, axes, shardings, size)
    assert layout == want
    if cfg.frontend is not None:
        assert local["frontend_proj"]["kernel"]  # its own shard: no model axis in its spec
        assert tp_lib.model_dim(shardings["frontend_proj"]["kernel"].spec) is None
    attn = local["shared_attn" if cfg.family == "hybrid" else "blocks"].get("attn", {})
    if "wk" in attn:
        assert attn["wk"]["kernel"] == want.kv_heads  # else gathered whole
    if cfg.attn_kind == "mla":  # the lora leaves whole, wo's rows split with the heads
        assert not any(attn[k]["kernel"] for k in ("wq_a", "wkv_a", "wq_b", "wk_b", "wv_b"))
        assert attn["wo"]["kernel"] == want.heads
    if cfg.ssm is not None:  # the packed leaves whole (where the rules split them at all),
        mamba = local["blocks"]["mamba"]  # out_proj's rows split with the heads
        sh = shardings["blocks"]["mamba"]
        for k in ("in_proj", "conv_w", "conv_b"):
            leaf, spec = (mamba[k]["kernel"], sh[k]["kernel"].spec) if k == "in_proj" else (
                mamba[k], sh[k].spec)
            assert leaf == (tp_lib.model_dim(spec) is None), k
        assert mamba["out_proj"]["kernel"] == want.ssm

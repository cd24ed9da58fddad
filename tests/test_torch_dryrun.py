"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: every
runnable cell traced at a reduced size on the ``tiny`` mesh, the eight
skips with the reference's reasons, full-size cells (granite-8b x
train_4k x pod, split over ``model``, against the repeat pattern's
per-device FLOPs; dbrx-132b x train_4k x pod's parameters per device), the
``card`` mesh's argument bytes against the tensors a prefill allocates, and
the JSON fields of the reference's ``run_cell``."""

import dataclasses
import json
import math

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.roofline import analysis as jax_analysis  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp_lib  # noqa: E402
from repro_torch.distributed.sharding import ShardingRules  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import params as params_lib  # noqa: E402

RUNNABLE = [(a, s) for a, s, ok, _ in configs.dryrun_cells() if ok]
SKIPPED = [(a, s, why) for a, s, ok, why in configs.dryrun_cells() if not ok]

# the reference's run_cell fields of an "ok" cell
REF_FIELDS = {f.name for f in dataclasses.fields(jax_analysis.CellAnalysis)} | {
    "status", "lower_s", "compile_s", "fallbacks", "plan", "params", "active_params"}
TERMS = {"compute", "memory", "collective"}


@pytest.mark.parametrize("arch, shape", RUNNABLE)
def test_reduced_cell_on_tiny(arch, shape, tmp_path):
    r = dryrun.run_cell(arch, shape, "tiny", out_dir=str(tmp_path), reduced=True)
    assert r["status"] == "ok", r.get("traceback")
    assert REF_FIELDS <= set(r)
    assert r["terms"]["dominant"] in TERMS and r["terms_fused"]["dominant"] in TERMS
    assert r["n_devices"] == 4 and r["trip_counts"] == [configs.get_config(arch, True).n_layers]
    assert r["flops"] > 0 and r["hbm_bytes"] > 0 and r["memory_stats"]["alias_bytes"] == 0
    assert min(r["memory_stats"].values()) >= 0 and r["memory_stats"]["argument_bytes"] > 0
    # the batch (8 at most, reduced) splits over tiny's data axis of 2
    assert r["device_batch"] == (4 if SHAPE_BATCH[shape] > 1 else 1)
    cfg = configs.get_config(arch, True)
    assert r["split"] == ("model" if tp_lib.splits(cfg) else "repeat")  # tiny's model axis is 2
    assert ("model all-reduce" in r["coll_bytes"]) == (r["split"] == "model")
    cached = dryrun.run_cell(arch, shape, "tiny", out_dir=str(tmp_path), reduced=True)
    assert cached == json.loads(json.dumps(r, default=str))


SHAPE_BATCH = {name: min(s.global_batch, 8) for name, s in configs.SHAPES.items()}


def test_the_eight_skips_with_their_reasons(tmp_path):
    assert len(SKIPPED) == 8
    for arch, shape, why in SKIPPED:
        r = dryrun.run_cell(arch, shape, "pod", out_dir=str(tmp_path))
        assert r == {"arch": arch, "shape": shape, "mesh": "pod", "status": "skip",
                     "reason": why}
        assert (False, why) == jax_configs.cell_status(arch, shape)
    assert {why for *_, why in SKIPPED} == {
        "encoder-only: no decode step",
        "pure full attention: 512k decode needs sub-quadratic attention"}


def _split_param_bytes(cfg, mesh) -> int:
    """bf16 bytes of the parameters one device of ``mesh`` computes with
    under the split: each leaf's model shard where the split takes one, the
    whole leaf where it does not (K/V, granite-8b's 8 kv heads on 16)."""
    rules = ShardingRules(mesh=mesh)
    size = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    total = 0
    for axes, shape in _spec_leaves(lm.param_spec(cfg)):
        spec = rules.spec_for(axes, shape)
        local = tp_lib.takes_model_shard(cfg, axes, spec, size)
        total += 2 * math.prod(shape) // (size if local and "model" in spec else 1)
    return total


def test_full_size_granite_train_on_pod(tmp_path):
    r = dryrun.run_cell("granite-8b", "train_4k", "pod", out_dir=str(tmp_path))
    assert r["status"] == "ok", r.get("traceback")
    cfg = configs.get_config("granite-8b")
    assert r["n_devices"] == 256 and r["device_batch"] == 256 // 16
    assert r["plan"]["remat"] == "minimal" and r["fallbacks"] == []
    # split over model: each bf16 parameter gathered over data to its model
    # shard (K/V whole), each such gradient all-reduced over data, and the
    # split's own reductions over model
    assert r["split"] == "model"
    n = lm.count_params(cfg)
    gathered = _split_param_bytes(cfg, dryrun.make_mesh("pod"))
    assert gathered < 2 * n // 8
    assert r["gathered_param_bytes"] == gathered
    assert {k: v for k, v in r["coll_bytes"].items() if not k.startswith("model")} == {
        "all-gather": float(gathered), "all-reduce": float(gathered)}
    assert r["coll_bytes"]["model all-reduce"] > 0 and r["coll_bytes"]["model all-gather"] > 0
    # per device: each bf16 parameter and its two float32 AdamW moments over
    # the devices its spec splits it across (FSDP x TP: 256 for the
    # matrices, 16 for the norms), the step counter, and the device's
    # (16, 4096) int32 tokens
    rules = ShardingRules(mesh=dryrun.make_mesh("pod"))
    per_device = 0
    for axes, shape in _spec_leaves(lm.param_spec(cfg)):
        spec = rules.spec_for(axes, shape)
        split = math.prod(16 for part in spec if part is not None)
        per_device += (2 + 4 + 4) * math.prod(shape) // split
    assert per_device < (2 + 4 + 4) * n // 16
    assert r["memory_stats"]["argument_bytes"] == per_device + 4 + 16 * 4096 * 4
    # the fused attention removes the materialized score volume
    assert r["flops_fused"] < r["flops"] and r["hbm_bytes_fused"] < r["hbm_bytes"]
    assert 0 < r["attn_flops_hlo"] < r["flops"]
    # the model axis (16) splits each data shard's compute: all but the
    # repeated K/V projections and the norms are useful
    assert 1 / 16 < r["useful_ratio"] < 1
    assert r["model_flops_global"] == pytest.approx(
        jax_analysis.model_flops(jax_configs.get_config("granite-8b"),
                                 jax_configs.base.SHAPES["train_4k"])
        + jax_analysis.attention_flops(jax_configs.get_config("granite-8b"),
                                       jax_configs.base.SHAPES["train_4k"]), rel=1e-12)


def test_split_divides_granite_flops_per_device():
    """granite-8b x train_4k on pod: one device's FLOPs under the split at
    least 8x below the repeat pattern's, which is a (16, 1) mesh's device
    (the same data shard, the model axis only repeating it)."""
    cfg = configs.get_config("granite-8b")
    shape = configs.SHAPES["train_4k"]
    flops = {}
    for dims in ((16, 16), (16, 1)):
        mesh = abstract_mesh(dims, ("data", "model"))
        tr = dryrun.trace_train(cfg, shape, mesh,
                                ShardingRules(mesh=mesh, plan=dryrun.plan_for(cfg, shape)))
        assert tr.device_shape.global_batch == 16
        flops[dims] = sum(tr.count.flops.values())
    assert flops[(16, 1)] >= 8 * flops[(16, 16)]


@pytest.mark.parametrize("arch", ["minicpm3-4b", "mamba2-130m", "zamba2-1.2b"])
def test_mla_ssm_and_hybrid_split_over_model_on_pod(arch):
    """train_4k on pod: the MLA, Mamba2 and hybrid families take the split
    (vocabulary and MLP columns split; zamba2-1.2b's 64 SSM heads and 32
    shared-block heads divide 16 and split too, minicpm3-4b's 40 heads and
    mamba2-130m's 24 SSM heads do not and repeat), against the repeat
    pattern's device (a (16, 1) mesh's, the same data shard): no more FLOPs
    or peak live bytes per device, zamba2-1.2b at least 4x fewer of both."""
    cfg = configs.get_config(arch)
    shape = configs.SHAPES["train_4k"]
    traces = {}
    for dims in ((16, 16), (16, 1)):
        mesh = abstract_mesh(dims, ("data", "model"))
        traces[dims] = dryrun.trace_train(cfg, shape, mesh, ShardingRules(
            mesh=mesh, plan=dryrun.plan_for(cfg, shape)))
    split, repeat = traces[(16, 16)], traces[(16, 1)]
    assert split.pattern == "model" and repeat.pattern == "repeat"
    flops = {k: sum(t.count.flops.values()) for k, t in traces.items()}
    peak = {k: t.count.peak_live_bytes for k, t in traces.items()}
    assert flops[(16, 16)] < flops[(16, 1)] and peak[(16, 16)] < peak[(16, 1)]
    if cfg.family == "hybrid":
        assert 4 * flops[(16, 16)] < flops[(16, 1)] and 4 * peak[(16, 16)] < peak[(16, 1)]
    assert split.param_bytes < repeat.param_bytes


#: peak live bytes per device of the repeat pattern at train_4k x pod (the
#: dry run's, before the encoder and the VLM split)
REPEAT_PEAK = {"hubert-xlarge": 88.4e9, "internvl2-1b": 118.2e9}


@pytest.mark.parametrize("arch", sorted(REPEAT_PEAK))
def test_encoder_and_vlm_split_over_model_on_pod(arch, tmp_path):
    """train_4k x pod: the audio encoder and the VLM take the split
    (hubert-xlarge's 16 heads split to one a device; internvl2-1b's 14
    repeat on 16, its MLP and vocabulary split), each device below the
    repeat pattern's peak live bytes, its attention at the local heads."""
    r = dryrun.run_cell(arch, "train_4k", "pod", out_dir=str(tmp_path))
    assert r["status"] == "ok", r.get("traceback")
    assert r["split"] == "model" and "model all-reduce" in r["coll_bytes"]
    assert r["memory_stats"]["temp_bytes"] < REPEAT_PEAK[arch]
    cfg = configs.get_config(arch)
    mesh = dryrun.make_mesh("pod")
    split = dryrun._split_for(cfg, mesh, ShardingRules(mesh=mesh).tree_shardings(
        lm.abstract_params(cfg), params_lib.logical_axes(lm.param_spec(cfg))))
    local = dryrun._device_cfg(cfg, split)
    heads = (1, 1) if arch == "hubert-xlarge" else (14, 2)  # internvl2-1b repeats attention
    assert (local.n_heads, local.n_kv_heads) == heads
    assert local.resolved_head_dim == cfg.resolved_head_dim


def test_dbrx_train_on_pod_fits_a_card(tmp_path):
    """dbrx-132b x train_4k on pod: the parameters one device gathers (its
    expert, its q heads, K/V whole, its vocabulary) under an H100's 80 GB,
    where the repeat pattern gathers all ~263 GB."""
    r = dryrun.run_cell("dbrx-132b", "train_4k", "pod", out_dir=str(tmp_path))
    assert r["status"] == "ok", r.get("traceback")
    cfg = configs.get_config("dbrx-132b")
    assert r["split"] == "model"
    assert r["gathered_param_bytes"] == _split_param_bytes(cfg, dryrun.make_mesh("pod")) < 80e9
    assert 2 * lm.count_params(cfg) > 250e9


def test_card_mesh_argument_bytes_are_the_allocated_bytes():
    """On the one-card mesh a prefill's argument bytes are those of the
    parameters, caches and tokens it allocates; a model axis of one
    repeats (splits nothing)."""
    cfg = configs.get_config("granite-8b", reduced=True)
    shape = ShapeConfig("p", 32, 2, "prefill")
    mesh = dryrun.make_mesh("card")
    tr = dryrun.trace_prefill(cfg, shape, mesh, ShardingRules(mesh=mesh,
                                                              plan=dryrun.plan_for(cfg, shape)))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    caches = lm.init_caches(cfg, 2, 32, device="cpu")
    tokens = torch.zeros(2, 32, dtype=torch.int32)
    leaves = [t for t in _leaves(params) + _leaves(caches) + [tokens]]
    assert tr.memory_stats["argument_bytes"] == sum(t.numel() * t.element_size() for t in leaves)
    assert tr.device_shape == shape and tr.coll_bytes == {"all-gather": 0.0}
    assert tr.pattern == "repeat" and tr.param_bytes == sum(
        t.numel() * t.element_size() for t in _leaves(params))


def _spec_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _spec_leaves(v)]
    return [(tuple(tree.logical_axes), tuple(tree.shape))]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def test_meshes_and_plan():
    assert {k: math.prod(s) for k, (s, _) in dryrun.MESHES.items()} == {
        "pod": 256, "multipod": 512, "pod2": 256, "pod8": 256, "pod32": 256, "tiny": 4,
        "tinypod": 8, "card": 1}
    assert dryrun.make_mesh("multipod").mesh_dim_names == ("pod", "data", "model")
    with pytest.raises(KeyError):
        dryrun.make_mesh("v5e")
    cfg = configs.get_config("mamba2-130m")
    assert dryrun.plan_for(cfg, configs.SHAPES["long_500k"]).sp
    assert not dryrun.plan_for(cfg, configs.SHAPES["train_4k"]).sp
    assert dryrun.plan_for(cfg, configs.SHAPES["decode_32k"]).remat == "none"


def test_main_counts_cells(tmp_path, capsys):
    rc = dryrun.main(["--arch", "hubert-xlarge", "--mesh", "tiny", "--reduced",
                      "--out", str(tmp_path)])
    assert rc == 0
    assert "2 ok, 2 skipped, 0 errors" in capsys.readouterr().out

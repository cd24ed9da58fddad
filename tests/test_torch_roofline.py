"""The port's analysis half against the JAX package's: the dry-run shapes
and cells, the parameter-count estimates, the meta-tensor inputs, the
analytic attention / model FLOPs, the roofline terms, the paper's FPGA
cycle model and ``cast_floats``; the eager op counter against the
reference's HLO parser on the same forwards; and the port's own kernel
costs, byte counts and meta-device wrappers."""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.configs import base as jax_base  # noqa: E402
from repro.core import latency_model as jax_lat  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import params as jax_params  # noqa: E402
from repro.roofline import analysis as jax_analysis  # noqa: E402
from repro.roofline import hlo_parser  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.core import latency_model as lat  # noqa: E402
from repro_torch.device import meta_trace, resolve_device  # noqa: E402
from repro_torch.kernels.flash_attention import mha  # noqa: E402
from repro_torch.kernels.layernorm import layernorm  # noqa: E402
from repro_torch.kernels.lut_softmax import lut_softmax  # noqa: E402
from repro_torch.kernels.qmatmul import qmatmul_int8  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_with_state  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import params as params_lib  # noqa: E402
from repro_torch.roofline import analysis, kernel_costs, op_counter  # noqa: E402

CELLS = [(a, s) for a, s, ok, _ in configs.dryrun_cells() if ok]


# ---------------------------------------------------------------- configs --


def test_shapes_equal():
    assert list(SHAPES) == list(jax_base.SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(jax_base.SHAPES[name])


def test_cell_status_and_dryrun_cells_equal():
    assert configs.dryrun_cells() == jax_configs.dryrun_cells()
    assert len(configs.dryrun_cells()) == 40 and len(CELLS) == 32
    for arch in configs.ARCH_NAMES:
        for shape in SHAPES:
            assert configs.cell_status(arch, shape) == jax_configs.cell_status(arch, shape)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES + configs.PHYSICS_NAMES)
def test_param_count_estimates_equal(arch):
    ours, ref = configs.get_config(arch), jax_configs.get_config(arch)
    assert ours.param_count_estimate() == ref.param_count_estimate()
    assert ours.active_param_count_estimate() == ref.active_param_count_estimate()


@pytest.mark.parametrize("arch, shape", [(a, s) for a, s, _, _ in configs.dryrun_cells()])
def test_input_specs_equal(arch, shape):
    ours = lm.input_specs(configs.get_config(arch), SHAPES[shape])
    ref = jax_lm.input_specs(jax_configs.get_config(arch), jax_base.SHAPES[shape])
    assert list(ours) == list(ref)
    for k, t in ours.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ref[k].shape)
        assert str(t.dtype).removeprefix("torch.") == str(ref[k].dtype)


@pytest.mark.parametrize("arch, shape", CELLS)
def test_attention_and_model_flops_equal(arch, shape):
    ours, ref = configs.get_config(arch), jax_configs.get_config(arch)
    s, rs = SHAPES[shape], jax_base.SHAPES[shape]
    for fn in ("attention_flops", "attention_io_bytes", "model_flops"):
        a, b = getattr(analysis, fn)(ours, s), getattr(jax_analysis, fn)(ref, rs)
        assert a == pytest.approx(b, rel=1e-12, abs=0.0), fn
    assert analysis._attn_geometry(ours) == jax_analysis._attn_geometry(ref)


# ---------------------------------------------------------- latency model --


def test_roofline_terms_equal_under_the_reference_spec():
    """The port carries no TPU figure: its ``HardwareSpec`` built from the
    reference's ``TPU_V5E`` fields gives the reference's terms."""
    hw = lat.HardwareSpec(**dataclasses.asdict(jax_lat.TPU_V5E))
    for flops, nbytes, coll in ((3.1e14, 2.2e11, 0.0), (1e9, 8e11, 5e9), (0.0, 0.0, 7e10)):
        for int8 in (False, True):
            a = lat.roofline(flops, nbytes, coll, hw, int8=int8)
            b = jax_lat.roofline(flops, nbytes, coll, jax_lat.TPU_V5E, int8=int8)
            assert (a.compute_s, a.memory_s, a.collective_s) == (
                b.compute_s, b.memory_s, b.collective_s)
            assert (a.dominant, a.bound_s, a.overlap_s, a.serial_s) == (
                b.dominant, b.bound_s, b.overlap_s, b.serial_s)
            assert lat.latency_us(a) == jax_lat.tpu_latency_us(b)
    # a spec without a by-type table prices every type but int8 at peak_flops
    assert hw.peak_for("float32") == hw.peak_flops and hw.peak_for("int8") == hw.peak_int8_ops


def test_h100_spec():
    h = lat.H100
    assert h.peak_for("bfloat16") == h.peak_for("float16") == h.peak_flops == 989e12
    assert h.peak_for("int8") == h.peak_int8_ops == 1979e12
    assert h.peak_for("tf32") == 495e12 and h.peak_for("tf32x3") == 495e12 / 3
    assert h.peak_for("float32") == 67e12 and h.peak_for("float64") == 67e12
    assert h.hbm_bw == 3.35e12 and h.ici_bw * h.ici_links == 450e9
    terms = lat.roofline_by_type({"bfloat16": 989e12, "float32": 67e12}, 3.35e12, 0.0)
    assert terms.compute_s == pytest.approx(2.0) and terms.memory_s == pytest.approx(1.0)
    assert terms.dominant == "compute"


@pytest.mark.parametrize("seq", [15, 50, 100])
@pytest.mark.parametrize("reuse", [1, 2, 4])
def test_fpga_style_estimate_identical(seq, reuse):
    for d, blocks in ((16, 3), (32, 2), (64, 3)):
        kw = dict(seq_len=seq, d_model=d, n_blocks=blocks, reuse=reuse)
        a, b = lat.fpga_style_estimate(**kw), jax_lat.fpga_style_estimate(**kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.latency_us == b.latency_us
    assert lat._PAPER_CLOCKS_NS == jax_lat._PAPER_CLOCKS_NS


def test_cast_floats_behaves_the_same():
    rng = np.random.default_rng(0)
    arrays = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "nested": {"b": rng.standard_normal(5).astype(np.float32),
                         "ids": np.arange(4, dtype=np.int32)}}
    ref = jax_params.cast_floats(jax.tree.map(jnp.asarray, arrays), jnp.bfloat16)
    ours = params_lib.cast_floats(
        params_lib.map_leaves(lambda _, a: torch.from_numpy(a.copy()), arrays), torch.bfloat16)
    for path in (("w",), ("nested", "b"), ("nested", "ids")):
        r, o = ref, ours
        for k in path:
            r, o = r[k], o[k]
        assert str(o.dtype).removeprefix("torch.") == str(r.dtype)
        np.testing.assert_array_equal(o.float().numpy() if o.is_floating_point() else o.numpy(),
                                      np.asarray(r, dtype=np.float32 if o.is_floating_point()
                                                 else r.dtype))


# ------------------------------------------------------------ op counter --


def _jax_forward_cost(arch, b, s):
    cfg = jax_configs.get_config(arch, reduced=True)
    params = jax_lm.abstract_params(cfg)
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}

    def fwd(p, bt):
        return jax_lm.forward(p, cfg, bt, mode="train")[0]

    compiled = jax.jit(fwd).lower(params, batch).compile()
    return cfg, hlo_parser.total_cost(compiled.as_text(), default_trip_count=cfg.n_layers)


def _meta_forward_count(arch, b, s):
    cfg = configs.get_config(arch, reduced=True)
    tokens = torch.empty(b, s, dtype=torch.int32, device="meta")
    with meta_trace():
        _, count = op_counter.count(lm.forward, lm.abstract_params(cfg), cfg,
                                    {"tokens": tokens}, mode="train", device="meta")
    return cfg, count


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-130m"])
def test_counter_flops_match_the_hlo_parser(arch):
    """The same reduced forward, counted eagerly on meta and parsed from the
    reference's compiled HLO: within 2 % (the gap found: none, both count
    the same dots and convolutions exactly)."""
    _, mc = _jax_forward_cost(arch, 2, 64)
    _, count = _meta_forward_count(arch, 2, 64)
    assert count.total_flops == pytest.approx(mc.flops, rel=0.02)
    assert count.total_flops == mc.flops  # the gap found
    assert count.attn_flops == mc.attn_flops


def test_attention_subset_is_the_score_volume():
    b, s = 2, 32
    cfg, count = _meta_forward_count("granite-8b", b, s)
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    assert count.attn_flops == cfg.n_layers * 2 * (2 * b * h * s * s * hd)
    assert 0 < count.attn_flops < count.total_flops
    assert set(count.attn.flops) == {"float32"}  # the plain attention computes in float32


def test_attention_subset_includes_the_backward():
    """Under autograd the backward of the tagged ops is attention volume
    too: QKᵀ and P·V each have two products in the backward."""
    b, s = 1, 16
    cfg = configs.get_config("granite-8b", reduced=True)
    params = lm.abstract_params(cfg)
    tokens = torch.empty(b, s, dtype=torch.int32, device="meta")
    leaves = [t.requires_grad_() for _, t in params_lib_leaves(params)]
    with meta_trace(), op_counter.OpCounter() as c:
        logits, _, _ = lm.forward(params, cfg, {"tokens": tokens}, mode="train", device="meta")
        torch.autograd.grad(logits.float().sum(), leaves)
    fwd = cfg.n_layers * 2 * (2 * b * cfg.n_heads * s * s * cfg.resolved_head_dim)
    assert c.result().attn_flops == 3 * fwd


def params_lib_leaves(tree, path=()):
    if not isinstance(tree, dict):
        return [(path, tree)]
    return [x for k in sorted(tree) for x in params_lib_leaves(tree[k], path + (k,))]


def test_bytes_of_a_two_op_graph():
    """x @ w then a ReLU: each op reads its inputs once and writes its
    output once; views count nothing."""
    x = torch.empty(8, 16, device="meta")
    w = torch.empty(16, 4, device="meta")
    with op_counter.OpCounter() as c:
        y = torch.relu(x @ w)
        y.t()  # a view
    count = c.result()
    assert count.n_ops == 2
    assert count.ops.bytes == 4 * ((8 * 16 + 16 * 4 + 8 * 4) + (8 * 4 + 8 * 4))
    assert count.flops == {"float32": 2.0 * 8 * 16 * 4}
    assert count.peak_live_bytes == 2 * 8 * 4 * 4  # x @ w and its ReLU, both alive


def test_counter_reads_the_same_on_cpu_and_meta():
    """The counter works on real tensors as on meta ones: a reduced
    granite-8b prefill counts the same on both."""
    cfg = configs.get_config("granite-8b", reduced=True)
    counts = []
    for dev in ("cpu", "meta"):
        with meta_trace(), torch.no_grad():
            params = (lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
                      if dev == "cpu" else lm.abstract_params(cfg, torch.float32))
            tokens = torch.zeros(2, 16, dtype=torch.int32, device=dev)
            caches = {g: {k: torch.zeros(s, dtype=dt, device=dev) for k, (s, dt) in l.items()}
                      for g, l in lm.abstract_caches(cfg, 2, 16, torch.float32).items()}
            _, c = op_counter.count(lm.prefill, params, cfg, {"tokens": tokens}, caches,
                                    device=dev)
        counts.append(c)
    cpu, meta = counts
    assert cpu.flops == meta.flops and cpu.ops.bytes == meta.ops.bytes
    assert cpu.attn_flops == meta.attn_flops
    assert [k.cost for k in cpu.calls] == [k.cost for k in meta.calls]
    assert all(not k.launched for k in cpu.calls)


def test_attnvol_tag_makes_nothing_without_a_counter():
    assert op_counter.ACTIVE is None
    assert type(op_counter.attnvol).__slots__ == ()
    with op_counter.attnvol as tag:
        assert tag is None and op_counter.ACTIVE is None


# ------------------------------------------------------------ kernel costs --


def _mask_pairs(lq, lkv, causal, window, kv_len):
    q = np.arange(lq)[:, None]
    k = np.arange(lkv)[None, :]
    m = np.broadcast_to(k < (lkv if kv_len is None else kv_len), (lq, lkv)).copy()
    if causal:
        m &= k <= q
    if window is not None:
        m &= q - k < window
    diag = int((m & (k == q)).sum()) if causal else 0
    return int(m.sum()) - diag / 2


@pytest.mark.parametrize("lq, lkv, causal, window, kv_len", [
    (16, 16, False, None, None), (16, 16, True, None, None), (40, 40, True, 8, None),
    (30, 30, True, 256, 20), (12, 20, False, 5, 17), (50, 50, False, None, None)])
def test_attention_pairs_hand_count(lq, lkv, causal, window, kv_len):
    assert kernel_costs.attention_pairs(lq, lkv, causal=causal, window=window,
                                        kv_len=kv_len) == _mask_pairs(lq, lkv, causal, window,
                                                                      kv_len)


def test_kernel_costs_hand_counts():
    c = kernel_costs.flash_attention(2, 8, 2, 16, 16, 32, 32, torch.bfloat16, causal=True)
    assert c.flops == {"bfloat16": 2.0 * 2 * 8 * (16 * 16 / 2) * 64}
    assert c.bytes == 2 * (2 * 8 * 16 * 32 + 2 * 2 * 16 * 64 + 2 * 8 * 16 * 32)
    c = kernel_costs.flash_attention(1, 4, 4, 10, 10, 96, 64, torch.float32, mode="lut")
    assert c.flops == {"tf32x3": 2.0 * 4 * 100 * 160}
    assert c.bytes == 4 * (4 * 10 * 96 + 4 * 10 * 160 + 4 * 10 * 64) + (1024 + 4096) * 4
    c = kernel_costs.layernorm(6, 32, torch.bfloat16, rms=False, use_lut=True)
    assert c.flops == {"float32": 8.0 * 6 * 32}
    assert c.bytes == 2 * 6 * 32 * 2 + 2 * 32 * 2 + 4096 * 4
    c = kernel_costs.layernorm(6, 32, torch.bfloat16, rms=True, param_dtype=torch.float32)
    assert c.bytes == 2 * 6 * 32 * 2 + 32 * 4
    c = kernel_costs.qmatmul(5, 7, 3)
    assert c.flops == {"int8": 2.0 * 5 * 7 * 3} and c.bytes == 35 + 21 + 4 * 8 + 4 * 15
    c = kernel_costs.lut_softmax(3, 50)
    assert c.flops == {"float32": 600.0} and c.bytes == 8 * 150 + (1024 + 4096) * 4
    c = kernel_costs.ssd_scan(2, 128, 4, 8, 16, 1, 64, torch.float32)
    q, nc = 64, 2
    assert c.flops == {"tf32x3": float(2 * nc * (1 * q * (q + 1) * 16
                                                 + 4 * (q * (q + 1) * 8 + 4 * q * 8 * 16)))}
    assert c.bytes == (4 * (2 * 2 * 128 * 4 * 8 + 2 * 128 * 4 + 2 * 2 * 128 * 16)
                       + 4 * 2 * 4 * 8 * 16)
    ms, by = kernel_costs.qmatmul(4096, 4096, 4096).bound()
    assert by == "operations" and ms == pytest.approx(2 * 4096 ** 3 / 1979e12 * 1e3)


@pytest.mark.parametrize("arch", ["granite-8b", "minicpm3-4b", "hubert-xlarge", "zamba2-1.2b",
                                  "internvl2-1b", "starcoder2-7b"])
def test_attention_calls_sum_to_attention_flops(arch):
    """A prefill's attention kernel calls (an encoder's forward's), priced
    by ``kernel_costs``, sum to ``analysis.attention_flops``: causal squares
    at L²/2, an encoder's at L², a window longer than the prompt clipping
    nothing.  Their bytes count each call's own width: a bf16 call with q/k
    and V at one head_dim moves exactly ``attention_io_bytes``, a float32
    call (internvl2's float32 patches promote its attention) twice that;
    MLA's V and output at 64 of q/k's 96 move less."""
    cfg = configs.get_config(arch)
    shape = ShapeConfig("p", 512, 2, "prefill")
    specs = lm.input_specs(cfg, shape)
    caches = None
    if not cfg.is_encoder:
        caches = {g: {k: torch.empty(s, dtype=dt, device="meta") for k, (s, dt) in l.items()}
                  for g, l in lm.abstract_caches(cfg, 2, 512).items()}
    with meta_trace(), torch.no_grad():
        _, count = op_counter.count(lm.forward, lm.abstract_params(cfg), cfg, specs,
                                    mode="prefill" if caches else "train", caches=caches,
                                    device="meta", in_place=True)
    calls = [c.cost for c in count.calls if c.cost.kernel == "flash_attention"]
    flops = math.fsum(c.total_flops for c in calls)
    assert flops == pytest.approx(analysis.attention_flops(cfg, shape), rel=1e-12)
    nbytes = math.fsum(c.bytes for c in calls)
    ref_bytes = analysis.attention_io_bytes(cfg, shape)
    if cfg.attn_kind == "mla":
        assert nbytes < ref_bytes
    else:
        wide = {"tf32x3": 2.0, "bfloat16": 1.0}[analysis.attention_type(count, cfg)]
        assert nbytes == pytest.approx(ref_bytes * wide, rel=1e-12)


# ------------------------------------------------------ wrappers on meta --


def test_wrappers_run_their_plain_version_on_meta():
    m = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    with op_counter.OpCounter() as c:
        assert mha(m(2, 4, 16, 32), m(2, 2, 16, 32), m(2, 2, 16, 32),
                   causal=True).shape == (2, 4, 16, 32)
        assert layernorm(m(6, 32), m(32), rms=True).shape == (6, 32)
        assert qmatmul_int8(m(5, 7, dt=torch.int8), m(7, 3, dt=torch.int8), m(5, 1),
                            m(1, 3)).shape == (5, 3)
        assert lut_softmax(m(3, 50)).shape == (3, 50)
        y, state = ssd_with_state(m(1, 128, 4, 8), m(1, 128, 4), m(1, 128, 1, 16),
                                  m(1, 128, 1, 16))
        assert y.shape == (1, 128, 4, 8) and state.shape == (1, 4, 8, 16)
    count = c.result()
    assert [k.cost.kernel for k in count.calls] == [
        "flash_attention", "layernorm", "qmatmul", "lut_softmax", "ssd_scan"]
    assert not any(k.launched for k in count.calls)
    assert set(count.plain) == {"flash_attention", "layernorm", "qmatmul", "lut_softmax",
                                "ssd_scan"}
    assert count.attn_in_plain.total_flops == count.attn.total_flops > 0


def test_entry_points_refuse_meta_outside_the_trace():
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        resolve_device("meta")
    with meta_trace():
        assert resolve_device("meta").type == "meta"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_fused_work_replaces_the_plain_versions():
    """On a meta count the fused FLOPs are the count's, less the attention
    and every plain version's volume, plus the attention re-priced and each
    other kernel call's cost."""
    cfg = configs.get_config("mamba2-130m")
    shape = ShapeConfig("p", 256, 2, "prefill")
    caches = {g: {k: torch.empty(s, dtype=dt, device="meta") for k, (s, dt) in l.items()}
              for g, l in lm.abstract_caches(cfg, 2, 256).items()}
    with meta_trace(), torch.no_grad():
        _, count = op_counter.count(lm.forward, lm.abstract_params(cfg), cfg,
                                    lm.input_specs(cfg, shape), mode="prefill", caches=caches,
                                    device="meta", in_place=True)
    flops, nbytes = analysis.fused_work(count, cfg, shape)
    kernels = {k.cost.kernel for k in count.calls}
    assert kernels == {"ssd_scan", "layernorm"} and count.attn_flops == 0
    plain = math.fsum(t.total_flops for t in count.plain.values())
    costs = math.fsum(k.cost.total_flops for k in count.calls)
    assert math.fsum(flops.values()) == pytest.approx(count.total_flops - plain + costs,
                                                      rel=1e-12)
    assert nbytes < count.hbm_bytes

"""The port's int8 4-stage streaming MHA (``repro_torch.core.streaming_mha``,
plain versions of its kernels on the CPU) against the JAX package's
``core/streaming_mha``, on weights quantized by the JAX package and carried
across by ``repro_torch.convert.streaming_mha_params_from_numpy``."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import quant as jquant  # noqa: E402
from repro.core import streaming_mha as jsm  # noqa: E402
from repro.kernels.qmatmul import qmatmul_prequantized as jax_qmatmul_prequantized  # noqa: E402
from repro_torch.convert import streaming_mha_params_from_numpy  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core import streaming_mha as tsm  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flash_attention import mha  # noqa: E402

# The JAX parity file's grid: heads x width x (causal, window) x softmax mode.
HEADS_WIDTH = [(2, 16), (4, 32), (8, 64)]
MASKS = [(False, None), (True, None), (True, 4)]
MODES = ["lut", "safe"]
GRID = list(itertools.product(HEADS_WIDTH, MASKS, MODES))

# Stage 1 is bitwise equal: the same int8 codes and scales, exact int32
# sums, the same epilogue.  Downstream, the two attentions sum in other
# float orders (and in lut mode may take a neighbouring table entry at a
# tie), so a stage-4 activation can differ by an ulp, which can move its
# row's scale by an ulp or flip one int8 code at a rounding tie.  So the
# output is held to 1e-5, except that under 1 % of the rows may differ by up
# to two stage-4 code steps (x_scale[row] * max_k |wo[k, n]| per step).  Seen
# on this grid: at most 3.6e-7, no row over 1e-5.
ATOL, FLIP_ROWS, FLIP_STEPS = 1e-5, 0.01, 2
FLOAT_REL = 0.1  # the JAX file's bound against the float oracle


def _weights(d, seed, bias=True):
    rng = np.random.default_rng(seed)
    ws = [(rng.normal(size=(d, d)) / np.sqrt(d)).astype(np.float32) for _ in range(4)]
    bs = [(0.1 * rng.normal(size=(d,))).astype(np.float32) for _ in range(4)] if bias else []
    return ws, bs


def _x(shape, seed=42):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _carry(jparams):
    """The JAX StreamingMHAParams as numpy, then the port's."""
    tree = {}
    for name in ("wq", "wk", "wv", "wo"):
        q = getattr(jparams, name)
        tree[name] = {"values": np.asarray(q.values), "scale": np.asarray(q.scale),
                      "axis": q.axis}
    for name in ("bq", "bk", "bv", "bo"):
        b = getattr(jparams, name)
        tree[name] = None if b is None else np.asarray(b)
    return streaming_mha_params_from_numpy(tree, "cpu")


def _params(ws, bs):
    jp = jsm.quantize_mha_params(*(jnp.asarray(a) for a in ws + bs))
    return jp, _carry(jp)


def _stage4_step(x, tp, n_heads, causal, window, mode):
    """One stage-4 code step per output element, from the port's own
    stage-4 activation scales."""
    b, s, d = x.shape
    flat = torch.from_numpy(x).reshape(b * s, d)
    q, k, v = (tsm.split_heads(tsm.int8_linear(flat, w, bias), b, s, n_heads)
               for w, bias in ((tp.wq, tp.bq), (tp.wk, tp.bk), (tp.wv, tp.bv)))
    o = mha(q, k, v, causal=causal, window=window, mode=mode).transpose(1, 2).reshape(b * s, -1)
    xs = tquant.quantize_int8(o, axis=0).scale.reshape(-1, 1)
    return (xs * tp.wo.dequantize().abs().amax(dim=0, keepdim=True)).numpy()


@pytest.mark.parametrize("hw,mask,mode", GRID, ids=str)
def test_matches_jax_streaming_mha(hw, mask, mode):
    (h, d), (causal, window) = hw, mask
    ws, bs = _weights(d, seed=h)
    jp, tp = _params(ws, bs)
    x = _x((2, 12, d))
    ref = np.asarray(jsm.streaming_mha(jnp.asarray(x), jp, n_heads=h, causal=causal,
                                       window=window, softmax_mode=mode))
    ours = tsm.streaming_mha(torch.from_numpy(x), tp, n_heads=h, causal=causal,
                             window=window, softmax_mode=mode).numpy()
    assert ours.shape == ref.shape == x.shape and np.isfinite(ours).all()
    err = np.abs(ours - ref).reshape(-1, d)
    over = err.max(-1) > ATOL
    assert over.mean() <= FLIP_ROWS, over.mean()
    step = _stage4_step(x, tp, h, causal, window, mode)
    assert (err[over] <= ATOL + FLIP_STEPS * step[over]).all()


@pytest.mark.parametrize("hw", HEADS_WIDTH, ids=str)
@pytest.mark.parametrize("which", ["wq", "wk", "wv", "wo"])
def test_stage1_and_4_projections_bitwise(hw, which):
    """Per-row activation codes times the carried weight codes, plus the
    bias: bitwise equal to the JAX package's _proj."""
    h, d = hw
    ws, bs = _weights(d, seed=h + 10)
    jp, tp = _params(ws, bs)
    flat = _x((24, d), seed=h)
    jw, tw = getattr(jp, which), getattr(tp, which)
    jb, tb = getattr(jp, "b" + which[1]), getattr(tp, "b" + which[1])
    ref = jax_qmatmul_prequantized(jquant.quantize_int8(jnp.asarray(flat), axis=0), jw) + jb
    ours = tsm.int8_linear(torch.from_numpy(flat), tw, tb)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("hw,mask", list(itertools.product(HEADS_WIDTH, MASKS)), ids=str)
def test_int8_lut_pipeline_tracks_float_ref(hw, mask):
    """The JAX file's bound: int8 GEMMs + LUT softmax within 10 % (relative
    Frobenius) of the float oracle, which both packages agree on."""
    (h, d), (causal, window) = hw, mask
    ws, _ = _weights(d, seed=h, bias=False)
    _, tp = _params(ws, [])
    x = _x((2, 12, d))
    out_q = tsm.streaming_mha(torch.from_numpy(x), tp, n_heads=h, causal=causal,
                              window=window, softmax_mode="lut").numpy()
    out_f = tsm.streaming_mha_float_ref(torch.from_numpy(x), *map(torch.from_numpy, ws),
                                        n_heads=h, causal=causal, window=window).numpy()
    rel = np.linalg.norm(out_q - out_f) / np.linalg.norm(out_f)
    assert rel < FLOAT_REL, rel
    ref_f = np.asarray(jsm.streaming_mha_float_ref(jnp.asarray(x), *map(jnp.asarray, ws),
                                                   n_heads=h, causal=causal, window=window))
    np.testing.assert_allclose(out_f, ref_f, atol=1e-5)


@pytest.mark.parametrize("n_heads", [2, 4])
def test_lut_vs_safe_softmax_agree_in_pipeline(n_heads):
    d = 8 * n_heads
    ws, _ = _weights(d, seed=7, bias=False)
    _, tp = _params(ws, [])
    x = torch.from_numpy(_x((1, 10, d)))
    out_lut = tsm.streaming_mha(x, tp, n_heads=n_heads, causal=True, softmax_mode="lut")
    out_safe = tsm.streaming_mha(x, tp, n_heads=n_heads, causal=True, softmax_mode="safe")
    assert float((out_lut - out_safe).norm() / out_safe.norm()) < 0.05


def test_causal_output_ignores_later_inputs():
    """tests/test_streaming_core.py's check: with a causal mask, position t
    does not depend on later inputs (the per-row quantization keeps rows
    apart)."""
    ws, _ = _weights(32, seed=2, bias=False)
    params = tsm.quantize_mha_params(*map(torch.from_numpy, ws))
    x = torch.from_numpy(_x((1, 8, 32), seed=0))
    full = tsm.streaming_mha(x, params, n_heads=4, causal=True)
    x2 = x.clone()
    x2[:, -1] = 99.0
    full2 = tsm.streaming_mha(x2, params, n_heads=4, causal=True)
    np.testing.assert_allclose(full[:, :-1].numpy(), full2[:, :-1].numpy(), atol=1e-5)


def test_quantize_mha_params_matches_and_converts():
    ws, bs = _weights(16, seed=3)
    jp, tp = _params(ws, bs)
    ours = tsm.quantize_mha_params(*(torch.from_numpy(a) for a in ws + bs))
    for name in ("wq", "wk", "wv", "wo"):
        a, b, c = getattr(ours, name), getattr(tp, name), getattr(jp, name)
        assert a.axis == b.axis == c.axis == 1 and a.shape == b.shape == c.shape
        assert a.values.dtype == b.values.dtype == torch.int8
        for t in (a, b):
            np.testing.assert_array_equal(t.values.numpy(), np.asarray(c.values))
            np.testing.assert_array_equal(t.scale.numpy(), np.asarray(c.scale))
    np.testing.assert_array_equal(ours.bo.numpy(), tp.bo.numpy())
    assert _params(ws, [])[1].bq is None


def test_against_the_pallas_attention_in_interpret_mode():
    ws, bs = _weights(32, seed=4)
    jp, tp = _params(ws, bs)
    x = _x((2, 12, 32), seed=1)
    ref = np.asarray(jsm.streaming_mha(jnp.asarray(x), jp, n_heads=4, causal=True,
                                       softmax_mode="lut", use_pallas_attention=True,
                                       interpret=True))
    ours = tsm.streaming_mha(torch.from_numpy(x), tp, n_heads=4, causal=True,
                             softmax_mode="lut").numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


def test_cpu_path_launches_no_kernel():
    ws, _ = _weights(16, seed=5, bias=False)
    params = tsm.quantize_mha_params(*map(torch.from_numpy, ws))
    before = dict(LAUNCHES)
    tsm.streaming_mha(torch.from_numpy(_x((1, 6, 16))), params, n_heads=2)
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("hw", HEADS_WIDTH, ids=str)
def test_kmajor_copies_of_the_weight_codes(hw):
    """The K-major copy the card's wgmma route reads is the codes' transpose,
    contiguous, both after quantize_mha_params and after carrying the JAX
    package's params across."""
    h, d = hw
    ws, bs = _weights(d, seed=h + 20)
    jp, carried = _params(ws, bs)
    local = tsm.quantize_mha_params(*(torch.from_numpy(a) for a in ws + bs))
    for params in (local, carried):
        assert sorted(params.kmajor) == sorted(tsm.WEIGHTS)
        for name in tsm.WEIGHTS:
            kmajor = params.kmajor[name]
            assert kmajor.is_contiguous() and kmajor.dtype == torch.int8
            assert torch.equal(kmajor, getattr(params, name).values.t().contiguous())
    for name in tsm.WEIGHTS:
        np.testing.assert_array_equal(carried.kmajor[name].numpy(),
                                      np.asarray(getattr(jp, name).values).T)

"""The port's attention (plain version behind ``repro_torch`` ``mha`` on the
CPU) against the JAX package's ``mha``, both its jnp path and its Pallas
kernel in interpret mode, on the same numpy inputs."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.flash_attention import mha as jax_mha  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flash_attention import mha, mha_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import kernel_head_dims  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

# safe: both sides sum in float32 in different orders (2e-5, as the JAX
# kernel test).  lut: 1e-4 as the JAX kernel test, for the same reason: a
# float-order difference in a score or a row sum can flip a nearest-table
# entry at a bin boundary.  Such a flip moves its whole row by one table step
# (against the jnp path: 2.4e-4 on 9 elements of one row in 800), so rows
# with a flip may reach 1e-3 and must be under 1 % of the rows.
ATOL = {"safe": 2e-5, "lut": 1e-4}
LUT_FLIP_ATOL, LUT_FLIP_ROWS = 1e-3, 0.01


def assert_close(ours, ref, mode):
    if mode == "safe":
        np.testing.assert_allclose(ours, ref, atol=ATOL["safe"], rtol=0)
        return
    err = np.abs(ours.astype(np.float32) - np.asarray(ref, np.float32))
    rows_flipped = (err > ATOL["lut"]).any(axis=-1).mean()
    assert err.max() <= LUT_FLIP_ATOL and rows_flipped <= LUT_FLIP_ROWS, (
        err.max(), rows_flipped)


def _qkv(b, hq, hkv, lq, lkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.normal(size=shape).astype(np.float32)
        for shape in ((b, hq, lq, d), (b, hkv, lkv, d), (b, hkv, lkv, d))
    )


def _both(qkv, use_pallas, **kw):
    ref = jax_mha(*(jnp.asarray(t) for t in qkv), use_pallas=use_pallas,
                  interpret=True, **kw)
    ours = mha(*(torch.from_numpy(t) for t in qkv), **kw)
    return np.asarray(ref), ours.numpy()


# (B, H, L, D) of engine_anomaly, btagging and gw at batch 8
PHYSICS_SHAPES = [(8, 2, 50, 8), (8, 8, 15, 8), (8, 4, 100, 8)]


@pytest.mark.parametrize("shape", PHYSICS_SHAPES)
@pytest.mark.parametrize("mode", ["safe", "lut"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_physics_shapes(shape, mode, use_pallas):
    b, h, l, d = shape
    ref, ours = _both(_qkv(b, h, h, l, l, d, seed=l), use_pallas, mode=mode)
    assert_close(ours, ref, mode)


@pytest.mark.parametrize("mode", ["safe", "lut"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_mask_grid_gqa(mode, causal, window, use_pallas):
    """The JAX kernel test's grid (GQA 4 query heads over 2 kv heads)."""
    ref, ours = _both(
        _qkv(2, 4, 2, 100, 100, 32, seed=1), use_pallas,
        causal=causal, window=window, mode=mode,
    )
    assert_close(ours, ref, mode)


@pytest.mark.parametrize("mode", ["safe", "lut"])
def test_padding_mask_kv_len(mode):
    q, k, v = _qkv(1, 2, 2, 40, 48, 16, seed=4)
    ref = jax_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        scale=1 / 4.0, mode=mode, kv_len=37, causal=True,
    )
    ours = mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
               mode=mode, kv_len=37, causal=True)
    assert_close(ours.numpy(), ref, mode)


def test_bf16_inputs():
    q, k, v = _qkv(1, 2, 2, 64, 64, 32, seed=7)
    ref = jax_mha(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), causal=True)
    ours = mha(*(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)), causal=True)
    assert ours.dtype == torch.bfloat16
    # both widen bf16 to float32, compute, and round once to bf16; a float
    # order difference can move that rounding by one bf16 ulp (2^-8 relative)
    np.testing.assert_allclose(
        ours.float().numpy(), np.asarray(ref, np.float32), atol=1e-2, rtol=0
    )


def test_cpu_path_launches_no_kernel_and_rejects_bad_args():
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 2, 2, 8, 8, 8))
    before = LAUNCHES["flash_attention"]
    mha(q, k, v)
    assert LAUNCHES["flash_attention"] == before
    with pytest.raises(ValueError):
        mha(q, k, v, mode="bogus")
    with pytest.raises(ValueError):
        mha(q, k, v, kv_len=0)
    with pytest.raises(ValueError):
        mha(q, k[:, :, :4], v)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mode", ["safe", "lut"])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_lm_head_dims_gqa(d, mode, window, use_pallas):
    """head_dim 64 and 128 (the tensor-core path on the card) at an LM-like
    GQA shape: 8 query heads over 2 kv heads, 256 tokens, causal."""
    ref, ours = _both(
        _qkv(1, 8, 2, 256, 256, d, seed=d), use_pallas,
        causal=True, window=window, mode=mode,
    )
    assert_close(ours, ref, mode)


# MLA's prefill attend (minicpm3-4b): q/k head_dim 96, V 64.  The reference
# zero-pads V to 96 for its fused kernel and slices the output back to 64
# (src/repro/models/attention.py, mla_apply); the port runs V at 64.
MLA_D, MLA_DV = 96, 64


def _v_padded(v: np.ndarray) -> np.ndarray:
    return np.pad(v, ((0, 0), (0, 0), (0, 0), (0, MLA_D - v.shape[-1])))


@pytest.mark.parametrize("mode", ["safe", "lut"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_v_head_dim_of_its_own_against_jax_v_padded(mode, causal, hq, hkv, use_pallas):
    """``mha`` at q/k 96 and V 64 equals the JAX ``mha`` (jnp path and
    Pallas kernel) with V zero-padded to 96 and the output sliced to 64."""
    q, k, v = _qkv(1, hq, hkv, 80, 80, MLA_D, seed=hq + hkv)
    v = v[..., :MLA_DV].copy()
    ref = jax_mha(*(jnp.asarray(t) for t in (q, k, _v_padded(v))), causal=causal, mode=mode,
                  use_pallas=use_pallas, interpret=True)[..., :MLA_DV]
    ours = mha(*(torch.from_numpy(t) for t in (q, k, v)), causal=causal, mode=mode)
    assert ours.shape == (1, hq, 80, MLA_DV)
    assert_close(ours.numpy(), np.asarray(ref), mode)


@pytest.mark.parametrize("mode", ["safe", "lut"])
def test_v_head_dim_of_its_own_with_kv_len(mode):
    q, k, v = _qkv(1, 4, 2, 40, 48, MLA_D, seed=5)
    v = v[..., :MLA_DV].copy()
    k_rep, v_rep = (jnp.repeat(jnp.asarray(t), 2, 1) for t in (k, _v_padded(v)))
    ref = jax_attention_ref(jnp.asarray(q), k_rep, v_rep, scale=1 / MLA_D ** 0.5, mode=mode,
                            kv_len=37, causal=True)[..., :MLA_DV]
    ours = mha(*(torch.from_numpy(t) for t in (q, k, v)), mode=mode, kv_len=37, causal=True)
    assert_close(ours.numpy(), np.asarray(ref), mode)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """float32 truncated to TF32 (10 mantissa bits), as the tensor cores
    read a 32-bit operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _veltkamp(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = big + small, big rounded to the nearest 11 significant bits by
    Veltkamp's split (2^13 + 1), small the exact rest (csrc split_fast)."""
    t = x * 8193.0
    big = t - (t - x)
    return big, x - big


def _tf32_matmul(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """a @ b as the card's float32 attention forms it on the tensor cores:
    a (Q or P) split by Veltkamp's method, b (K or V) into its raw value,
    which the tensor cores read truncated to TF32, and the exact rest; every
    small half read truncated.  Three products (small*big + big*small +
    big*big) or, for comparison, big*big alone.  Every product of two TF32
    values is exact in float32."""
    ab, as_ = _veltkamp(a)
    bb = _tf32_trunc(b)
    if products == 1:
        return ab @ bb
    return _tf32_trunc(as_) @ bb + ab @ _tf32_trunc(b - bb) + ab @ bb


# (B, H, L, D, causal, V head_dim): the tensor-core path at (1, 2, 512, D)
# causal, MLA's q/k 96 with V 64 among them; head_dim 8 / 16 / 32 at the
# physics shapes (unmasked) and at (1, 8, 1024, 16) causal
TF32_CASES = {"64": (1, 2, 512, 64, True, 64), "128": (1, 2, 512, 128, True, 128),
              "96x64": (1, 2, 512, MLA_D, True, MLA_DV)}
TF32_CASES.update({f"{b}x{h}x{l}x{d}": (b, h, l, d, False, d)
                   for b, h, l, _ in PHYSICS_SHAPES for d in (8, 16, 32)})
TF32_CASES["1x8x1024x16-causal"] = (1, 8, 1024, 16, True, 16)


@pytest.mark.parametrize("case", list(TF32_CASES.values()), ids=list(TF32_CASES))
def test_float32_path_needs_three_tf32_products(case):
    """The kernel's TF32 split emulated in plain torch: three TF32 products
    stay within the float32 tolerance (2e-5) of the plain version, one does
    not (10 mantissa bits move the output by ~1e-3)."""
    b, h, l, d, causal, dv = case
    q, k, v = (torch.from_numpy(t) for t in _qkv(b, h, h, l, l, d, seed=11))
    v = v[..., :dv].contiguous()
    ref = mha_ref(q, k, v, causal=causal)
    mask = torch.ones(l, l, dtype=torch.bool)
    if causal:
        mask = mask.tril()
    errs = {}
    for products in (3, 1):
        s = _tf32_matmul(q, k.transpose(-1, -2), products) * (1.0 / d ** 0.5)
        p = torch.softmax(torch.where(mask, s, -torch.inf), dim=-1)
        errs[products] = float((_tf32_matmul(p, v, products) - ref).abs().max())
    assert errs[3] <= ATOL["safe"], errs
    assert errs[1] > 10 * ATOL["safe"], errs


def _f32(x) -> np.float32:
    return np.float32(x)


def _rn(fr: Fraction) -> np.float32:
    """A rational rounded to the nearest float32, ties to even."""
    x = np.float32(float(fr))
    best = x
    for cand in (np.nextafter(x, np.float32(-np.inf)), np.nextafter(x, np.float32(np.inf))):
        dc, db = abs(Fraction(float(cand)) - fr), abs(Fraction(float(best)) - fr)
        if dc < db or (dc == db and int(np.array(cand).view(np.int32)) % 2 == 0):
            best = cand
    return best


def test_lut_index_without_division_picks_the_plain_entry():
    """The small-head kernel's exp-table index (csrc/lut.cuh,
    lut_index_linear_fast), emulated with exact rationals for its two FMAs:
    q = d / step by a multiply with the rounded reciprocal, Markstein's
    correction q + (d - q step) / step, a clamp, then rounding by adding
    1.5 * 2^23.  It must pick the plain version's entry (a true division)
    everywhere, also for quotients within a few ulps of a half-integer,
    where a reciprocal multiply alone picks the neighbour."""
    from repro_torch.core import lut

    off, step = (_f32(c) for c in lut.index_constants(lut.EXP_SPEC))
    inv = _f32(1.0) / step
    rng = np.random.default_rng(0)
    xs = [_f32(x) for x in rng.uniform(-12, 12, 1500)]
    for kk in rng.integers(-2, 1026, 500):  # quotients next to kk + 0.5
        x = _f32(_f32((kk + 0.5) * float(step)) + off)
        xs += [x, np.nextafter(x, _f32(np.inf)), np.nextafter(x, _f32(-np.inf))]
    ours, recip = [], []
    for x in xs:
        d = _f32(x - off)
        q = _f32(d * inv)
        r = _rn(Fraction(float(d)) - Fraction(float(q)) * Fraction(float(step)))
        quot = _rn(Fraction(float(r)) * Fraction(float(inv)) + Fraction(float(q)))
        idx = min(max(quot, _f32(0)), _f32(lut.EXP_SPEC.size - 1))
        big = _f32(idx + _f32(12582912.0))
        ours.append(int(np.array(big).view(np.int32)) - int(np.array(_f32(12582912.0)).view(np.int32)))
        recip.append(int(np.clip(np.rint(q), 0, lut.EXP_SPEC.size - 1)))
    plain = lut.lut_index(torch.tensor(np.array(xs)), lut.EXP_SPEC).tolist()
    assert ours == plain
    assert recip != plain  # the test reaches the inputs where the correction matters


# head_dims outside the kernel's (8, 16, 32, 64, 128): minicpm-2b /
# granite-moe-3b reduced (12), internvl2-1b reduced (14), hubert-xlarge (80),
# MLA's q/k (96)
PADDED_DIMS = [12, 14, 80, 96]


@pytest.mark.parametrize("d", PADDED_DIMS)
@pytest.mark.parametrize("mode", ["safe", "lut"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_head_dims_outside_the_kernels(d, mode, use_pallas):
    ref, ours = _both(_qkv(1, 4, 2, 64, 64, d, seed=d), use_pallas, causal=True, mode=mode)
    assert ours.shape == ref.shape == (1, 4, 64, d)
    assert_close(ours, ref, mode)


@pytest.mark.parametrize("d", PADDED_DIMS)
@pytest.mark.parametrize("mode", ["safe", "lut"])
def test_zero_padded_head_dim_gives_the_same_attention(d, mode):
    """What ``mha`` runs on the card for such a D: q, k, v zero-padded to the
    next square instance, the scale at 1/sqrt(true D), the output sliced
    back to D.  At 96, MLA's pair (q/k 96, V 64) runs natively, nothing
    padded, and equals the reference's form (V zero-padded to 96, the output
    sliced to 64)."""
    dv = MLA_DV if d == MLA_D else d
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 4, 4, 64, 64, d, seed=d + 1))
    v = v[..., :dv].contiguous()
    dk, dvk = kernel_head_dims(d, dv)
    assert (dk, dvk) == {12: (16, 16), 14: (16, 16), 80: (128, 128), 96: (96, 64)}[d]
    padded = [torch.nn.functional.pad(t, (0, dk - d)) for t in (q, k)]
    padded.append(torch.nn.functional.pad(v, (0, dvk - dv)))
    out = attention_ref(*padded, scale=1.0 / d ** 0.5, causal=True, mode=mode)[..., :dv]
    plain = mha_ref(q, k, v, causal=True, mode=mode)
    assert_close(out.numpy(), plain.numpy(), mode)
    if dv != d:
        v_padded = torch.nn.functional.pad(v, (0, d - dv))
        ref_form = attention_ref(q, k, v_padded, scale=1.0 / d ** 0.5, causal=True,
                                 mode=mode)[..., :dv]
        assert_close(plain.numpy(), ref_form.numpy(), mode)


def test_padded_head_dim_bounds():
    assert [kernel_head_dims(d)[0] for d in (1, 8, 9, 32, 33, 64, 65, 96, 128)] == [
        8, 8, 16, 32, 64, 64, 128, 128, 128]
    assert kernel_head_dims(MLA_D, MLA_DV) == (96, 64)  # native: nothing padded
    with pytest.raises(ValueError, match="head_dim 192"):
        kernel_head_dims(192)
    for d, dv in ((96, 32), (64, 32), (80, 64)):  # no instance takes these pairs
        with pytest.raises(ValueError, match="no kernel instance"):
            kernel_head_dims(d, dv)

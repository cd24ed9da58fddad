"""The port's staged LayerNorm (plain version behind ``repro_torch``
``layernorm`` on the CPU) against the JAX package's Pallas kernel in
interpret mode and its jnp functions, over LN/RMS x exact/LUT."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import layernorm as jax_ln  # noqa: E402
from repro.kernels.layernorm import layernorm as jax_layernorm  # noqa: E402
from repro_torch.kernels.layernorm import layernorm  # noqa: E402

# float32 sums in different orders (1e-5, as the JAX kernel test).  In LUT
# mode a row whose variance sits within 1 % of an entry spacing of a
# half-step tie of the 1/sqrt table may pick the neighbouring entry (float32
# log2 is not exact in either package, see test_torch_core): that row is
# scaled by the next entry, 0.27 % away, and is held to that instead.
ATOL = 1e-5
LUT_STEP = 2.0 ** (0.5 * 32 / 4095) - 1  # ratio of neighbouring 1/sqrt entries


def _tie_rows(x, rms):
    """Rows whose variance (or mean square) sits at a 1/sqrt-table tie."""
    from repro_torch.core import lut

    x64 = x.astype(np.float64)
    dm = x64 if rms else x64 - x64.mean(-1, keepdims=True)
    off, step = lut.index_constants(lut.RSQRT_SPEC)
    pos = (np.log2((dm * dm).mean(-1)) - off) / step
    return np.abs(pos - np.floor(pos) - 0.5) < 1e-2


def assert_close(ours, ref, x, use_lut, rms):
    ref = np.asarray(ref)
    tie = _tie_rows(x, rms) if use_lut else np.zeros(len(x), bool)
    np.testing.assert_allclose(ours[~tie], ref[~tie], atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours[tie], ref[tie], atol=ATOL, rtol=LUT_STEP * 1.01)


# (rows, K): physics (batch 8 x seq, d) for btagging and gw, then the JAX
# kernel test's shapes
SHAPES = [(8 * 15, 64), (8 * 100, 32), (64, 96), (128, 48), (1, 16), (33, 200)]


def _inputs(rows, k, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, k)) * 3.0).astype(np.float32)
    g = rng.normal(size=(k,)).astype(np.float32)
    b = rng.normal(size=(k,)).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("rows,k", SHAPES)
@pytest.mark.parametrize("use_lut", [False, True])
@pytest.mark.parametrize("rms", [False, True])
def test_matches_pallas_kernel_and_jnp(rows, k, use_lut, rms):
    x, g, b = _inputs(rows, k, rows + k)
    ref_kernel = jax_layernorm(
        jnp.asarray(x), jnp.asarray(g), None if rms else jnp.asarray(b),
        use_lut=use_lut, rms=rms, use_pallas=True, interpret=True,
    )
    if rms:
        ref_jnp = jax_ln.rmsnorm(jnp.asarray(x), jnp.asarray(g), eps=1e-5, use_lut=use_lut)
    else:
        ref_jnp = jax_ln.layernorm_paper(
            jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), eps=1e-5, use_lut=use_lut
        )
    ours = layernorm(
        torch.from_numpy(x), torch.from_numpy(g), None if rms else torch.from_numpy(b),
        use_lut=use_lut, rms=rms,
    ).numpy()
    assert_close(ours, ref_kernel, x, use_lut, rms)
    assert_close(ours, ref_jnp, x, use_lut, rms)


def test_leading_dims_and_arg_checks():
    x, g, b = _inputs(24, 32, 5)
    x3 = torch.from_numpy(x).reshape(2, 12, 32)
    out = layernorm(x3, torch.from_numpy(g), torch.from_numpy(b))
    assert out.shape == (2, 12, 32)
    flat = layernorm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b))
    np.testing.assert_array_equal(out.reshape(24, 32).numpy(), flat.numpy())
    with pytest.raises(ValueError):
        layernorm(x3, torch.from_numpy(g)[:16], torch.from_numpy(b))


# bfloat16 / float16 x: both packages widen x to float32, compute, and round
# once to x's dtype, so a float-order difference can move that rounding by
# one ulp of the output dtype on top of the float32 atol.  One ulp is
# 2^-7 (bf16) or 2^-10 (fp16) of the value's binade: up to twice the unit
# roundoff (2^-8, 2^-11) relative to the value itself, so it is computed
# per element rather than as an rtol.
MANTISSA_BITS = {"bfloat16": 7, "float16": 10}


def _ulp(ref, dtype):
    """One ulp of ``dtype`` at each |ref| (normal range; fp16 subnormals
    share the smallest normal's ulp)."""
    floor = -14 if dtype == "float16" else -126
    e = np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** floor)))
    return 2.0 ** (e - MANTISSA_BITS[dtype])


def _half_inputs(rows, k, seed, dtype):
    """x rounded to ``dtype`` (the same values in both packages), as a
    float32 numpy array, a torch tensor and a jax array of that dtype."""
    x, g, b = _inputs(rows, k, seed)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    return xt.float().numpy(), xt, jnp.asarray(x).astype(getattr(jnp, dtype)), g, b


def assert_close_half(ours, ref, x32, use_lut, rms, dtype):
    assert str(ours.dtype).split(".")[-1] == dtype == str(ref.dtype)
    ours, ref = ours.float().numpy(), np.asarray(ref, np.float32)
    tie = _tie_rows(x32, rms) if use_lut else np.zeros(len(x32), bool)
    limit = ATOL + _ulp(ref, dtype) + np.where(tie[:, None], LUT_STEP * 1.01 * np.abs(ref), 0)
    err = np.abs(ours - ref)
    assert (err <= limit).all(), (err - limit).max()


@pytest.mark.parametrize("rows,k", SHAPES)
@pytest.mark.parametrize("use_lut", [False, True])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_x_matches_pallas_kernel(rows, k, use_lut, rms, dtype):
    """A bf16 / fp16 x with float32 gamma and beta returns x's dtype."""
    x32, xt, xj, g, b = _half_inputs(rows, k, rows + k, dtype)
    ref = jax_layernorm(xj, jnp.asarray(g), None if rms else jnp.asarray(b),
                        use_lut=use_lut, rms=rms, use_pallas=True, interpret=True)
    ours = layernorm(xt, torch.from_numpy(g), None if rms else torch.from_numpy(b),
                     use_lut=use_lut, rms=rms)
    assert_close_half(ours, ref, x32, use_lut, rms, dtype)


@pytest.mark.parametrize("rows,k", SHAPES[:3])
@pytest.mark.parametrize("use_lut", [False, True])
def test_layernorm_without_beta_is_zero_beta(rows, k, use_lut):
    x, g, _ = _inputs(rows, k, rows * k)
    ref = jax_layernorm(jnp.asarray(x), jnp.asarray(g), None, use_lut=use_lut,
                        use_pallas=True, interpret=True)
    ours = layernorm(torch.from_numpy(x), torch.from_numpy(g), use_lut=use_lut)
    assert_close(ours.numpy(), ref, x, use_lut, False)
    zeros = layernorm(torch.from_numpy(x), torch.from_numpy(g), torch.zeros(k), use_lut=use_lut)
    np.testing.assert_array_equal(ours.numpy(), zeros.numpy())


@pytest.mark.parametrize("bits", [(12, 6), (16, 6)])
@pytest.mark.parametrize("rows,k", SHAPES[:3])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("use_lut", [False, True])
def test_fixed_output_precision_matches_pallas_kernel(bits, rows, k, rms, use_lut):
    """precision= snaps the output onto the ap_fixed grid.  A value that the
    two float orders put on both sides of a grid midpoint lands one grid step
    apart (on top of the float32 / table-step tolerance)."""
    from repro.core import precision as jprec
    from repro_torch.core import precision as tprec

    prec = tprec.fixed(*bits)
    jp = jprec.Precision.from_dict(prec.to_dict())
    x, g, b = _inputs(rows, k, rows + k + bits[0])
    ref = np.asarray(jax_layernorm(jnp.asarray(x), jnp.asarray(g), None if rms else jnp.asarray(b),
                                   use_lut=use_lut, rms=rms, use_pallas=True, interpret=True,
                                   precision=jp))
    ours = layernorm(torch.from_numpy(x), torch.from_numpy(g),
                     None if rms else torch.from_numpy(b), use_lut=use_lut, rms=rms,
                     precision=prec).numpy()
    step = prec.fixed_cfg().step
    assert np.array_equal(ours, np.round(ours / step) * step)  # on the grid
    tie = _tie_rows(x, rms) if use_lut else np.zeros(rows, bool)
    err = np.abs(ours - ref)
    assert (err[~tie] <= ATOL + step).all()
    assert (err[tie] <= ATOL + step + LUT_STEP * 1.01 * np.abs(ref[tie])).all()
    assert (err > ATOL).mean() <= 0.01, (err > ATOL).mean()


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("use_lut", [False, True])
def test_model_norm_bf16_matches_jax(kind, use_lut):
    """models.layers.norm hands bf16 x and bf16 params to the kernel as
    they are; the JAX norm casts them to float32 and back."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    x32, xt, xj, g, b = _half_inputs(2 * 37, 64, 11, "bfloat16")
    gt, bt = (torch.from_numpy(v).to(torch.bfloat16) for v in (g, b))
    params_t = {"scale": gt, "bias": bt} if kind == "layernorm" else {"scale": gt}
    params_j = {n: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                for n, t in params_t.items()}
    ref = jlayers.norm(params_j, xj.reshape(2, 37, 64), kind, 1e-5, use_lut=use_lut)
    ours = tlayers.norm(params_t, xt.reshape(2, 37, 64), kind, 1e-5, use_lut=use_lut)
    assert ours.shape == (2, 37, 64)
    # the tie rule reads rows of x as the norm sees them (bf16 gamma is exact)
    assert_close_half(ours.reshape(-1, 64), np.asarray(ref).reshape(-1, 64), x32, use_lut,
                      kind == "rmsnorm", "bfloat16")


def test_plans_cover_the_row_and_name_a_kernel_instance():
    """Every (VEC, NV, lanes) the wrapper plans covers K and is one of the
    instances that csrc/layernorm.cu:dispatch compiles; the documented
    routes: K = 32 float32 is 8 lanes (4 rows per warp), mamba2's 768 a warp
    per row and 1536 float32 a block per row, a few rows (decode) a block
    per row at 8 elements per thread, K = 33 single elements."""
    import re
    from pathlib import Path

    from repro_torch.kernels.layernorm import ops

    src = (Path(ops.__file__).resolve().parents[2] / "csrc" / "layernorm.cu").read_text()
    instances = set(re.findall(r"REPRO_LN_CASE\((V|1), (\d+), (\d+)\)", src))
    assert len(instances) == 24
    for itemsize in (4, 2):
        for vector in (True, False):
            for few_rows in (False, True):
                for k in [*range(1, 1100), 1536, 2048, 3072, 4096, 8192, 16384, 32768]:
                    vec, nv, lanes = ops._plan(k, itemsize, vector, few_rows)
                    assert vec * nv * lanes >= k and (lanes <= 32 or lanes % 32 == 0)
                    tag = ("V" if vec == 16 // itemsize else "1", str(nv),
                           str(0 if lanes > 32 else lanes))
                    assert vec in (1, 16 // itemsize) and tag in instances, (k, itemsize)
    assert ops._plan(32, 4, True) == (4, 1, 8)
    assert ops._plan(64, 2, True) == (8, 1, 8)
    assert ops._plan(48, 4, True) == (4, 1, 16)
    assert ops._plan(768, 4, True) == (4, 6, 32)
    assert ops._plan(768, 2, True) == (8, 3, 32)
    assert ops._plan(1536, 4, True) == (4, 4, 96)
    assert ops._plan(1536, 4, True, True) == (4, 2, 192)
    assert ops._plan(768, 2, True, True) == (8, 1, 96)
    assert ops._plan(4096, 2, True) == (8, 4, 128)
    assert ops._plan(4096, 4, True) == (4, 4, 256)
    assert ops._plan(8192, 4, True) == (4, 4, 512)
    assert ops._plan(33, 4, True) == (1, 2, 32)
    assert ops._plan(200, 4, False) == (1, 8, 32)
    with pytest.raises(ValueError, match="too long"):
        ops._plan(40000, 4, True)

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

"""The port's 3-stage LUT softmax (``repro_torch.kernels.lut_softmax``, its
plain version on the CPU) and ``core.softmax`` against the JAX package's, on
the same numpy inputs: the JAX ``lut_softmax`` runs its Pallas kernel in
interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import precision as jprec  # noqa: E402
from repro.core import softmax as jsm  # noqa: E402
from repro.kernels.lut_softmax import lut_softmax as jax_lut_softmax  # noqa: E402
from repro.kernels.lut_softmax import lut_softmax_ref as jax_lut_softmax_ref  # noqa: E402
from repro_torch.core import lut as tlut  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import softmax as tsm  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.lut_softmax import (  # noqa: E402
    lut_softmax,
    lut_softmax_ref,
    softmax_exact_ref,
)

SHAPES = [(64, 64), (2, 4, 48, 48), (1, 16), (128, 100), (3, 5, 7)]
PRECISIONS = [None, tprec.fixed(12, 6), tprec.fixed(16, 6), tprec.int8()]


def _rand(shape, seed, scale=2.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _inv_tie_rows(x):
    """Rows whose exp-table sum lies within 1 % of an entry spacing of a
    half-step tie of the 1/x table: there a float-order or log2 ulp may
    pick the neighbouring entry (as in test_torch_core's
    test_lut_index_matches)."""
    e = tlut.lut_exp(torch.from_numpy(x)).double()
    s = e.sum(-1).numpy()
    off, step = tlut.index_constants(tlut.INV_SPEC)
    pos = (np.log2(s) - off) / step
    return np.abs(pos - np.floor(pos) - 0.5) < 1e-2


def _both(x, precision):
    jp = None if precision is None else jprec.Precision.from_dict(precision.to_dict())
    ref = np.asarray(jax_lut_softmax(jnp.asarray(x), use_pallas=True, interpret=True,
                                     precision=jp))
    ours = lut_softmax(torch.from_numpy(x), precision=precision).numpy()
    return ours, ref


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("precision", PRECISIONS, ids=str)
def test_matches_pallas_interpret(shape, precision):
    """Bitwise away from 1/x-table ties; at a tie the row may take the
    neighbouring entry (0.76 % apart), then cross one output grid level."""
    x = _rand(shape, seed=sum(shape) % 97)
    ours, ref = _both(x, precision)
    assert ours.shape == ref.shape == shape and ours.dtype == np.float32
    differ = (ours != ref).reshape(-1, shape[-1]).any(-1)
    assert not (differ & ~_inv_tie_rows(x).reshape(-1)).any()
    step = 0.008 * np.abs(ref)
    if precision is not None and precision.kind == "fixed":
        step = step + precision.fixed_cfg().step
    assert (np.abs(ours - ref) <= step).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_ref(shape):
    x = _rand(shape, seed=len(shape))
    ref = np.asarray(jax_lut_softmax_ref(jnp.asarray(x)))
    ours = lut_softmax_ref(torch.from_numpy(x)).numpy()
    differ = (ours != ref).reshape(-1, shape[-1]).any(-1)
    assert not (differ & ~_inv_tie_rows(x).reshape(-1)).any()


def test_lut_close_to_exact_softmax():
    x = torch.from_numpy(_rand((64, 64), 1))
    assert float((lut_softmax_ref(x) - softmax_exact_ref(x)).abs().max()) < 0.02
    np.testing.assert_allclose(softmax_exact_ref(x).numpy(),
                               np.asarray(jnp.asarray(jsm.softmax_safe(jnp.asarray(x.numpy())))),
                               atol=1e-6)


def test_rows_sum_to_one():
    out = lut_softmax(torch.from_numpy(_rand((32, 50), 2)))
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=0.02)


def test_saturation_matches_ap_fixed_semantics():
    """Out-of-domain scores saturate (AP_SAT) instead of overflowing."""
    x = np.asarray([[100.0, 0.0, -100.0]], np.float32)
    ours, ref = _both(x, None)
    np.testing.assert_array_equal(ours, ref)
    assert np.isfinite(ours).all() and ours[0, 0] > ours[0, 1] > ours[0, 2]


def test_restructured_matches_legacy_hls4ml():
    """Sec. IV-B: e^{z_i} (sum_j e^{z_j})^-1 equals the original
    (sum_j e^{z_j - z_i})^-1 in exact arithmetic; both packages agree."""
    x = _rand((8, 24), 3, scale=1.0)
    new = tsm.softmax_paper_exact(torch.from_numpy(x)).numpy()
    legacy = tsm.softmax_legacy_hls4ml(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(new, legacy, rtol=2e-5)
    np.testing.assert_allclose(legacy, np.asarray(jsm.softmax_legacy_hls4ml(jnp.asarray(x))),
                               rtol=1e-6)


@pytest.mark.parametrize("mode", ["safe", "paper", "lut", "legacy"])
def test_softmax_modes_match(mode):
    # float32 sums in different orders (1e-6); the seed keeps rows off ties
    x = np.random.default_rng(5).normal(0, 3, size=(16, 40)).astype(np.float32)
    ref = np.asarray(jsm.softmax(jnp.asarray(x), mode=mode))
    np.testing.assert_allclose(tsm.softmax(torch.from_numpy(x), mode=mode).numpy(), ref,
                               atol=1e-6, rtol=1e-5)


def test_softmax_lut_other_axis_matches():
    x = np.random.default_rng(6).normal(0, 3, size=(12, 9, 5)).astype(np.float32)
    ref = np.asarray(jsm.softmax_lut(jnp.asarray(x), axis=1))
    np.testing.assert_allclose(tsm.softmax_lut(torch.from_numpy(x), dim=1).numpy(), ref,
                               atol=1e-6, rtol=1e-5)
    with pytest.raises(NotImplementedError):
        tsm.softmax_legacy_hls4ml(torch.from_numpy(x), dim=1)
    with pytest.raises(ValueError):
        tsm.softmax(torch.from_numpy(x), mode="bogus")


@pytest.mark.parametrize("k", [1, 16, 128, 1024])
@pytest.mark.parametrize("mode", ["paper", "lut", "safe", "legacy"])
def test_op_count_k_vs_k_squared(k, mode):
    """The point of the restructure: k exponentials, not k^2."""
    assert tsm.op_count(k, mode) == jsm.op_count(k, mode) == (k * k if mode == "legacy" else k)


def test_cpu_path_launches_no_kernel_and_keeps_dtype():
    x = torch.from_numpy(_rand((4, 10), 8))
    before = LAUNCHES["lut_softmax"]
    lut_softmax(x)
    assert LAUNCHES["lut_softmax"] == before
    assert lut_softmax(x.to(torch.bfloat16)).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        lut_softmax(torch.tensor(1.0))

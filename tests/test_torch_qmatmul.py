"""The port's int8 GEMM (``repro_torch.kernels.qmatmul``, its plain version
on the CPU) and reuse-factor plan against the JAX package's, on the same
numpy inputs: the JAX ``qmatmul`` runs its Pallas kernel in interpret mode."""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import precision as jprec  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core import reuse as jreuse  # noqa: E402
from repro.kernels.qmatmul import qmatmul as jax_qmatmul  # noqa: E402
from repro.kernels.qmatmul import qmatmul_pallas as jax_qmatmul_pallas  # noqa: E402
from repro.kernels.qmatmul import qmatmul_prequantized as jax_qmatmul_prequantized  # noqa: E402
from repro.kernels.qmatmul import qmatmul_ref as jax_qmatmul_ref  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core import reuse as treuse  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.qmatmul import (  # noqa: E402
    qmatmul,
    qmatmul_int8,
    qmatmul_prequantized,
    qmatmul_ref,
    route,
)

SHAPES = [(8, 16, 8), (100, 300, 200), (128, 128, 128), (7, 130, 65), (1, 256, 512)]
# The JAX kernel test's tolerance.  The JAX ``qmatmul`` is jitted, and XLA
# turns the quantizer's ``amax / qmax`` into a multiply by the reciprocal,
# which moves some row scales by one ulp (6 of 100 rows at (100, 300, 200));
# the port divides as the eager JAX quantizer does, and against the eager
# JAX arithmetic (quantize_int8, then qmatmul_ref) it is bitwise equal.
RTOL, ATOL = 1e-5, 1e-4


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize(
    "m,k,n,r,strategy",
    [(m, k, n, r, s) for (m, k, n), r, s in itertools.product(
        [(8, 16, 8), (100, 300, 200), (512, 2048, 512), (1, 4096, 4096), (4096, 64, 16)],
        [1, 2, 3, 4, 8, 16],
        ["LATENCY", "RESOURCE"],
    )],
)
def test_plan_matches_field_for_field(m, k, n, r, strategy):
    kw = dict(reuse_factor=r)
    jp = jreuse.plan_matmul(m, k, n, strategy=jreuse.Strategy[strategy], **kw)
    tp = treuse.plan_matmul(m, k, n, strategy=treuse.Strategy[strategy], **kw)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert tp.interval == jp.interval
    assert (dataclasses.asdict(treuse.resource_estimate(tp))
            == dataclasses.asdict(jreuse.resource_estimate(jp)))


def test_plan_constants_and_errors_match():
    for name in ("MXU_DIM", "LANE", "SUBLANE", "VMEM_BYTES"):
        assert getattr(treuse, name) == getattr(jreuse, name)
    assert [s.value for s in treuse.Strategy] == [s.value for s in jreuse.Strategy]
    with pytest.raises(ValueError):
        treuse.plan_matmul(8, 8, 8, reuse_factor=0)


def _both_qmatmul(x, w, r=1, precision=None):
    """(port, JAX Pallas kernel in interpret mode, eager JAX arithmetic)."""
    jp = None if precision is None else jprec.Precision.from_dict(precision.to_dict())
    ref = np.asarray(jax_qmatmul(jnp.asarray(x), jnp.asarray(w), reuse_factor=r,
                                 use_pallas=True, interpret=True, precision=jp))
    ours = qmatmul(torch.from_numpy(x), torch.from_numpy(w), reuse_factor=r,
                   precision=precision).numpy()
    per_channel = precision is None or precision.per_channel
    bits = 8 if precision is None else precision.bits
    xq = jquant.quantize_int8(jnp.asarray(x), axis=0 if per_channel else None, bits=bits)
    wq = jquant.quantize_int8(jnp.asarray(w), axis=1 if per_channel else None, bits=bits)
    eager = np.asarray(jax_qmatmul_ref(
        xq.values, wq.values, jnp.broadcast_to(xq.scale.reshape(-1, 1), (x.shape[0], 1)),
        jnp.broadcast_to(wq.scale.reshape(1, -1), (1, w.shape[1]))))
    return ours, ref, eager


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("r", [1, 2, 4, 8])
def test_qmatmul_matches_pallas_interpret(m, k, n, r):
    x, w = _rand((m, k), 1), _rand((k, n), 2)
    ours, ref, eager = _both_qmatmul(x, w, r)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ours, eager)


@pytest.mark.parametrize("per_channel,bits", [(False, 8), (True, 6), (True, 4), (False, 4)])
def test_qmatmul_precision_variants(per_channel, bits):
    x, w = _rand((100, 300), 3), _rand((300, 200), 4)
    prec = tprec.int8(per_channel=per_channel, bits=bits)
    ours, ref, eager = _both_qmatmul(x, w, 2, prec)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ours, eager)
    # the codes and scales on both sides are bitwise equal
    for a, axis in ((x, 0), (w, 1)):
        ax = axis if per_channel else None
        jq = jquant.quantize_int8(jnp.asarray(a), axis=ax, bits=bits)
        tq = tquant.quantize_int8(torch.from_numpy(a), axis=ax, bits=bits)
        np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
        np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))


def test_qmatmul_rejects_non_int8_precision():
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="int8"):
        qmatmul(x, x, precision=tprec.fixed(12, 6))


def test_int8_accumulation_is_int32_exact():
    """Unit scales: the output is the int32 sum itself, against numpy int64
    and the JAX Pallas kernel (the JAX test's case, plus K = 4096 at the
    code extremes, where an int8 product sum would wrap)."""
    rng = np.random.default_rng(7)
    for k in (256, 4096):
        xq = rng.integers(-128, 128, (64, k), dtype=np.int8)
        wq = rng.integers(-128, 128, (k, 64), dtype=np.int8)
        xq[0], wq[:, 0] = -128, -128
        expected = (xq.astype(np.int64) @ wq.astype(np.int64)).astype(np.float32)
        ours = qmatmul_int8(torch.from_numpy(xq), torch.from_numpy(wq),
                            torch.ones(64, 1), torch.ones(1, 64)).numpy()
        np.testing.assert_array_equal(ours, expected)
        if k == 256:
            ref = jax_qmatmul_pallas(jnp.asarray(xq), jnp.asarray(wq), jnp.ones((64, 1)),
                                     jnp.ones((1, 64)), block_m=64, block_n=64, block_k=128,
                                     interpret=True)
            np.testing.assert_array_equal(ours, np.asarray(ref))


@pytest.mark.parametrize("x_axis,w_axis", [(0, 1), (None, None), (0, None), (None, 1)])
def test_prequantized_matches(x_axis, w_axis):
    x, w = _rand((33, 40), 5), _rand((40, 24), 6)
    jx = jquant.quantize_int8(jnp.asarray(x), axis=x_axis)
    jw = jquant.quantize_int8(jnp.asarray(w), axis=w_axis)
    tx = tquant.quantize_int8(torch.from_numpy(x), axis=x_axis)
    tw = tquant.quantize_int8(torch.from_numpy(w), axis=w_axis)
    ref = np.asarray(jax_qmatmul_prequantized(jx, jw))
    ours = qmatmul_prequantized(tx, tw).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert qmatmul_prequantized(tx, tw, torch.bfloat16).dtype == torch.bfloat16


def test_quantization_error_bounded():
    x, w = _rand((32, 64), 5), _rand((64, 32), 6)
    out = qmatmul(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    exact = x @ w
    assert np.linalg.norm(out - exact) / np.linalg.norm(exact) < 0.05


def test_cpu_path_launches_no_kernel_and_checks_shapes():
    x, w = torch.zeros(4, 8, dtype=torch.int8), torch.zeros(8, 3, dtype=torch.int8)
    before = LAUNCHES["qmatmul"]
    out = qmatmul_int8(x, w, torch.ones(4, 1), torch.ones(1, 3))
    assert out.shape == (4, 3) and LAUNCHES["qmatmul"] == before
    with pytest.raises(ValueError):
        qmatmul_int8(x, w[:4], torch.ones(4, 1), torch.ones(1, 3))
    with pytest.raises(ValueError):
        qmatmul_int8(x, w, torch.ones(4), torch.ones(1, 3))
    with pytest.raises(ValueError):
        qmatmul_int8(x, w, torch.ones(4, 1), torch.ones(1, 3), grid_k=0)
    # torch.mm on int8 wraps; the plain version must not
    big = torch.full((2, 64), 127, dtype=torch.int8)
    assert float(qmatmul_ref(big, big.t().contiguous(), torch.ones(2, 1),
                             torch.ones(1, 2))[0, 0]) == 127 * 127 * 64


def test_quantize_pytree_int8_matches():
    rng = np.random.default_rng(9)
    tree = {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "inner": {"k": rng.normal(size=(2, 3, 4)).astype(np.float32),
                      "b": rng.normal(size=(5,)).astype(np.float32)}}
    for axis in (0, None):
        ref = jquant.quantize_pytree_int8(
            {"w": jnp.asarray(tree["w"]),
             "inner": {k: jnp.asarray(v) for k, v in tree["inner"].items()}}, axis=axis)
        ours = tquant.quantize_pytree_int8(
            {"w": torch.from_numpy(tree["w"]),
             "inner": {k: torch.from_numpy(v) for k, v in tree["inner"].items()}}, axis=axis)
        for jq, tq in ((ref["w"], ours["w"]), (ref["inner"]["k"], ours["inner"]["k"])):
            assert tq.axis == jq.axis and tq.shape == jq.shape
            np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
            np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
        np.testing.assert_array_equal(ours["inner"]["b"].numpy(), tree["inner"]["b"])


@pytest.mark.parametrize("k,n,expected", [
    (16, 16, "stream"), (32, 32, "stream"), (64, 64, "stream"), (48, 40, "stream"),
    (20, 30, "stream"), (1, 1, "stream"), (64, 65, "wide"), (65, 64, "wide"), (80, 16, "wide"),
    (16, 80, "wide"), (4096, 4096, "wide"), (130, 8, "wide"), (300, 24, "wide"),
])
def test_route_is_chosen_by_k_and_n_alone(k, n, expected):
    """The card's route: the streaming kernel for K and N up to 64 (the
    encoders' projections), the wgmma kernel beyond either."""
    assert route(k, n) == expected


def test_w_kmajor_is_checked_and_leaves_the_plain_version_unchanged():
    rng = np.random.default_rng(13)
    xq = torch.from_numpy(rng.integers(-128, 128, (9, 40), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-128, 128, (40, 24), dtype=np.int8))
    xs, ws = torch.rand(9, 1) + 0.1, torch.rand(1, 24) + 0.1
    base = qmatmul_int8(xq, wq, xs, ws)
    assert torch.equal(qmatmul_int8(xq, wq, xs, ws, w_kmajor=wq.t().contiguous()), base)
    for bad in (wq, wq.t()[:, :39].contiguous(), wq.t().contiguous().to(torch.int16)):
        with pytest.raises(ValueError, match="w_kmajor"):
            qmatmul_int8(xq, wq, xs, ws, w_kmajor=bad)
    with pytest.raises(ValueError, match="devices"):
        qmatmul_int8(xq, wq, xs, ws, w_kmajor=wq.t().contiguous().to("meta"))
    tx = tquant.quantize_int8(torch.randn(9, 40), axis=0)
    tw = tquant.quantize_int8(torch.randn(40, 24), axis=1)
    assert torch.equal(qmatmul_prequantized(tx, tw, w_kmajor=tw.values.t().contiguous()),
                       qmatmul_prequantized(tx, tw))

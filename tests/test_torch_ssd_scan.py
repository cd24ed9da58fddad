"""The port's SSD chunked scan (plain version behind
``repro_torch.kernels.ssd_scan.ssd`` on the CPU) against the JAX package's
Pallas kernel in interpret mode and its naive recurrence, over the grid of
``tests/test_kernels_ssd_scan.py``; and the port's ``ssd_chunked``,
``ssd_naive_ref`` and ``ssd_step`` against ``repro.models.ssm``.

Tolerance: 1e-4 absolute, as the JAX tests (float32 sums in other orders:
the chunked form against the step recurrence)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd_scan import ssd as jax_ssd  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_naive as jax_scan_naive  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_ref as jax_scan_ref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd,
    ssd_scan_naive,
    ssd_scan_ref,
    ssd_with_state,
)
from repro_torch.models import ssm  # noqa: E402

ATOL = 1e-4


def _inputs(b=2, l=64, h=3, p=16, n=24, seed=0):
    """The JAX kernel test's inputs (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    xdt = (rng.normal(size=(b, l, h, p)) * 0.5).astype(np.float32)
    a = (-np.abs(rng.normal(size=(b, l, h))) * 0.3).astype(np.float32)
    bm = (rng.normal(size=(b, l, h, n)) * 0.5).astype(np.float32)
    cm = (rng.normal(size=(b, l, h, n)) * 0.5).astype(np.float32)
    return xdt, a, bm, cm


def _t(arrays):
    return [torch.from_numpy(x) for x in arrays]


def _fold(t):
    """(b, l, h, ·) -> (b*h, l, ·), the kernel layout."""
    b, l, h = t.shape[:3]
    return t.transpose(0, 2, 1, 3).reshape(b * h, l, t.shape[-1])


def _jax_naive(xdt, a, bm, cm):
    b, l, h, p = xdt.shape
    out = jax_scan_naive(*(jnp.asarray(_fold(t)) for t in (xdt, a[..., None], bm, cm)))
    return np.asarray(out).reshape(b, h, l, p).transpose(0, 2, 1, 3)


def _pallas(xdt, a, bm, cm, chunk):
    return np.asarray(jax_ssd(*(jnp.asarray(t) for t in (xdt, a, bm, cm)), chunk=chunk,
                              use_pallas=True, interpret=True))


@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_matches_pallas_and_naive(chunk):
    x = _inputs(seed=chunk)
    out = ssd(*_t(x), chunk=chunk).numpy()
    np.testing.assert_allclose(out, _pallas(*x, chunk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, _jax_naive(*x), atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,l,h,p,n", [(1, 32, 1, 8, 8), (2, 128, 2, 32, 16), (1, 64, 4, 64, 64)])
def test_shape_sweep(b, l, h, p, n):
    x = _inputs(b, l, h, p, n, seed=l + p)
    out = ssd(*_t(x), chunk=32).numpy()
    np.testing.assert_allclose(out, _pallas(*x, 32), atol=ATOL, rtol=0)
    ref = np.asarray(jax_ssd(*(jnp.asarray(t) for t in x), chunk=32, use_pallas=False))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_chunk_size_invariance():
    x = _t(_inputs(seed=9))
    outs = [ssd(*x, chunk=c) for c in (8, 16, 64)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], atol=ATOL, rtol=0)


def test_strong_decay_truncates_history():
    xdt, a, bm, cm = _inputs(seed=11)
    out1 = ssd(*_t((xdt, a * 50.0, bm, cm)), chunk=16)
    xdt0 = xdt.copy()
    xdt0[:, 0] = 0.0
    out2 = ssd(*_t((xdt0, a * 50.0, bm, cm)), chunk=16)
    assert torch.isfinite(out1).all()
    torch.testing.assert_close(out1[:, -1], out2[:, -1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(out1.numpy(), _pallas(xdt, a * 50.0, bm, cm, 16), atol=ATOL, rtol=0)


@pytest.mark.parametrize("l", [1, 5, 12])
def test_length_below_chunk(l):
    """chunk = min(chunk, l): one chunk of l steps, as the reference."""
    x = _inputs(l=l, seed=l)
    out = ssd(*_t(x), chunk=64).numpy()
    np.testing.assert_allclose(out, _pallas(*x, 64), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, _jax_naive(*x), atol=ATOL, rtol=0)


def test_length_not_a_multiple_of_the_chunk_raises():
    x = _t(_inputs(l=40, seed=1))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd(*x, chunk=16)
    with pytest.raises(ValueError, match="shapes disagree"):
        ssd(x[0], x[1][:, :, :2], x[2], x[3], chunk=8)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_grouped_b_c_match_per_head_copies(g):
    """ssd_with_state reads B and C per group (head i -> group i // (h/g)),
    as mamba_apply hands them over; the same as the expanded per-head copies
    through the reference's chunked scan, y and final state."""
    xdt, a, bm, cm = _inputs(b=2, l=48, h=4, p=8, n=16, seed=g)
    bg, cg = bm[:, :, :g], cm[:, :, :g]
    y, state = ssd_with_state(*_t((xdt, a, bg, cg)), chunk=16)
    rep = lambda t: jnp.repeat(jnp.asarray(t), 4 // g, axis=2)  # noqa: E731
    y_ref, s_ref = jssm.ssd_chunked(jnp.asarray(xdt), jnp.asarray(a), rep(bg), rep(cg), chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(state.numpy(), np.asarray(s_ref), atol=ATOL, rtol=0)


def test_bf16_inputs_upcast_as_the_kernel():
    """bf16 in: computed in float32 (as the Pallas kernel), y rounded to
    bf16, state float32."""
    x = _inputs(seed=4)
    xb = [torch.from_numpy(t).to(torch.bfloat16) for t in x]
    y, state = ssd_with_state(*xb, chunk=32)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    y32, s32 = ssd_with_state(*(t.float() for t in xb), chunk=32)
    assert torch.equal(y, y32.to(torch.bfloat16))
    assert torch.equal(state, s32)


def test_scan_layout_refs_match_jax():
    """(BH, L, ·) oracles: y against the JAX package's, and their final
    states against each other."""
    xdt, a, bm, cm = _inputs(seed=2)
    xdt, a, bm, cm = _fold(xdt), _fold(a[..., None]), _fold(bm), _fold(cm)
    y_ref, s_ref = ssd_scan_ref(*_t((xdt, a, bm, cm)), chunk=16)
    y_naive, s_naive = ssd_scan_naive(*_t((xdt, a, bm, cm)))
    np.testing.assert_allclose(
        y_ref.numpy(), np.asarray(jax_scan_ref(*map(jnp.asarray, (xdt, a, bm, cm)), chunk=16)),
        atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        y_naive.numpy(), np.asarray(jax_scan_naive(*map(jnp.asarray, (xdt, a, bm, cm)))),
        atol=ATOL, rtol=0)
    torch.testing.assert_close(s_ref, s_naive, atol=ATOL, rtol=0)
    assert s_ref.shape == (xdt.shape[0], xdt.shape[-1], bm.shape[-1])


# ---------------------------------------------------------------------------
# models.ssm: ssd_chunked / ssd_naive_ref / ssd_step against the reference
# ---------------------------------------------------------------------------


def _ssm_inputs(b=2, l=32, h=3, p=8, n=16, seed=0):
    """The inputs of tests/test_ssm.py."""
    return _inputs(b, l, h, p, n, seed)


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_ssd_chunked_y_and_state_match_reference(chunk):
    x = _ssm_inputs()
    y, s = ssm.ssd_chunked(*_t(x), chunk=chunk)
    y_ref, s_ref = jssm.ssd_chunked(*map(jnp.asarray, x), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=ATOL, rtol=0)
    y_n, s_n = ssm.ssd_naive_ref(*_t(x))
    yj_n, sj_n = jssm.ssd_naive_ref(*map(jnp.asarray, x))
    np.testing.assert_allclose(y_n.numpy(), np.asarray(yj_n), atol=ATOL, rtol=0)
    np.testing.assert_allclose(s_n.numpy(), np.asarray(sj_n), atol=ATOL, rtol=0)
    torch.testing.assert_close(y, y_n, atol=ATOL, rtol=0)


def test_initial_state_threading():
    x = _ssm_inputs(seed=3)
    y_full, s_full = ssm.ssd_chunked(*_t(x), chunk=8)
    first = [torch.from_numpy(t[:, :16]) for t in x]
    second = [torch.from_numpy(t[:, 16:]) for t in x]
    y1, s1 = ssm.ssd_chunked(*first, chunk=8)
    y2, s2 = ssm.ssd_chunked(*second, chunk=8, initial_state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, atol=ATOL, rtol=0)
    torch.testing.assert_close(s2, s_full, atol=ATOL, rtol=0)
    yj, sj = jssm.ssd_chunked(*(jnp.asarray(t) for t in (t[:, 16:] for t in x)), chunk=8,
                              initial_state=jnp.asarray(s1.numpy()))
    np.testing.assert_allclose(y2.numpy(), np.asarray(yj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(s2.numpy(), np.asarray(sj), atol=ATOL, rtol=0)


def test_ssd_step_matches_reference_and_scan():
    xdt, a, bm, cm = _ssm_inputs(b=2, l=8, seed=5)
    rng = np.random.default_rng(6)
    dt = rng.uniform(0.1, 1.0, size=(2, 3)).astype(np.float32)
    state = np.asarray(rng.normal(size=(2, 3, 8, 16)), np.float32)
    for t in range(8):
        args = (state, xdt[:, t], dt, a[:, t], bm[:, t], cm[:, t])
        y, new = ssm.ssd_step(*_t(args))
        yj, newj = jssm.ssd_step(*map(jnp.asarray, args))
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=ATOL, rtol=1e-6)
        np.testing.assert_allclose(new.numpy(), np.asarray(newj), atol=ATOL, rtol=1e-6)
        state = new.numpy()
    # with dt = 1 the step recurrence is the naive scan (tests/test_ssm.py)
    ones = torch.ones(2, 3)
    s = torch.zeros(2, 3, 8, 16)
    ys = []
    for t in range(8):
        y, s = ssm.ssd_step(s, *_t((xdt[:, t],)), ones, *_t((a[:, t], bm[:, t], cm[:, t])))
        ys.append(y)
    y_ref, s_ref = ssm.ssd_naive_ref(*_t((xdt, a, bm, cm)))
    torch.testing.assert_close(torch.stack(ys, 1), y_ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(s, s_ref, atol=ATOL, rtol=0)


def test_strong_decay_prefix_sums_keep_their_digits():
    """Under strong decay the in-chunk prefix sums reach |cs| ~ 1e3, and a
    float32 difference cs_i - cs_j keeps only ~|cs| 2^-24 of its digits: the
    reference's float32 ssd_chunked is 1.6e-4 off the float64 y here (|y| <=
    13).  The port sums in float64 (plain version and kernel), so its float32
    result stays within 2e-5 of a float64 run of the same algorithm."""
    xdt, a, bm, cm = _inputs(b=2, l=128, h=4, p=64, n=128, seed=1)
    a = a * 50.0
    bg, cg = bm[:, :, :1], cm[:, :, :1]
    y, state = ssd_with_state(*_t((xdt, a, bg, cg)), chunk=64)
    rep = lambda t: torch.from_numpy(t).double().repeat_interleave(4, dim=2)  # noqa: E731
    y64, s64 = ssm.ssd_chunked(torch.from_numpy(xdt).double(), torch.from_numpy(a).double(),
                               rep(bg), rep(cg), chunk=64)
    torch.testing.assert_close(y.double(), y64, atol=2e-5, rtol=0)
    torch.testing.assert_close(state.double(), s64, atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# The card's kernel (csrc/ssd_scan.cu) emulated in plain torch: its three
# passes (chunk states, state passing, output) and its precision plan
# ---------------------------------------------------------------------------


def _tf32_nearest(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest TF32 value (10 mantissa bits), ties to
    even, as Veltkamp's split by 2^13 + 1 does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """float32 as the tensor cores read it in a TF32 operand: the low 13 bits
    dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_tf32(x):
    """The kernel's split: big = x rounded to the nearest TF32 value, small
    the exact rest, read truncated to TF32."""
    big = _tf32_nearest(x)
    return big, _tf32_truncated(x - big)


def _split_bf16(x):
    """bf16 hi + lo: hi = x rounded to bf16, lo = the rest rounded to bf16."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _split_mm(split, products):
    """a @ b as the tensor cores form it from operands split by ``split``
    into (big, small): three products (small*big + big*small + big*big) or
    big*big alone.  An operand that the split keeps exact has small = 0.
    Every product of two such values is exact in float32."""
    def mm(a, b):
        (ab, as_), (bb, bs) = split(a), split(b)
        if products == 1:
            return ab @ bb
        return as_ @ bb + ab @ bs + ab @ bb
    return mm


def _exact_mm(a, b):
    return (a.double() @ b.double()).float()


def _kernel_emulated(xdt, a, bm, cm, chunk, mm_state, mm_cb, mm_gx, mm_cs):
    """The kernel's arithmetic: pass 1 S_c = (xdt * exp(cs_last - cs))^T B;
    pass 2 S_in[c+1] = exp(cs_last) S_in[c] + S_c from S_in[0] = 0; pass 3
    y = (C B^T * L) xdt + (exp(cs) C) S_in^T with C B^T once per group; cs in
    float64.  ``mm_*`` form the four products.  B and C per group."""
    b, l, h, p = xdt.shape
    g, n = bm.shape[2:]
    rep, nc, q = h // g, l // chunk, chunk
    x = xdt.float().reshape(b, nc, q, h, p).permute(0, 1, 3, 2, 4)  # (b, c, h, q, p)
    cs = torch.cumsum(a.double().reshape(b, nc, q, h).permute(0, 1, 3, 2), dim=-1)
    bg = bm.float().reshape(b, nc, q, g, n).permute(0, 1, 3, 2, 4)  # (b, c, g, q, n)
    cg = cm.float().reshape(b, nc, q, g, n).permute(0, 1, 3, 2, 4)
    w = torch.exp((cs[..., -1:] - cs).float())
    chunk_states = mm_state((x * w[..., None]).transpose(-1, -2), bg.repeat_interleave(rep, 2))
    decay = torch.exp(cs[..., -1].float())  # (b, c, h)
    s = torch.zeros_like(chunk_states[:, 0])
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = decay[:, c, :, None, None] * s + chunk_states[:, c]
    cb = mm_cb(cg, bg.transpose(-1, -2)).repeat_interleave(rep, 2)  # (b, c, h, q, q)
    low = torch.ones(q, q, dtype=torch.bool).tril()
    el = torch.where(low, torch.exp((cs[..., :, None] - cs[..., None, :]).float()
                                    .masked_fill(~low, 0.0)), 0.0)
    y = mm_gx(cb * el, x) + mm_cs(cg.repeat_interleave(rep, 2) * torch.exp(cs.float())[..., None],
                                  torch.stack(s_in, 1).transpose(-1, -2))
    return y.permute(0, 1, 3, 2, 4).reshape(b, l, h, p), s


# (b, l, h, p, n, groups, chunk): mamba2-130m's widths over 4 heads, the JAX
# kernel test's per-head shape, a narrower grouped one
EMULATED = {"mamba2": (1, 256, 4, 64, 128, 1, 64), "per-head": (2, 128, 3, 16, 24, 3, 32),
            "grouped": (1, 128, 4, 32, 64, 2, 64)}


def _grouped_inputs(b, l, h, p, n, groups, seed=0):
    xdt, a, bm, cm = _inputs(b, l, h, p, n, seed)
    return _t((xdt, a, bm[:, :, :groups], cm[:, :, :groups]))


def _plain(xdt, a, bm, cm, chunk):
    rep = xdt.shape[2] // bm.shape[2]
    return ssm.ssd_chunked(xdt.float(), a.float(), bm.float().repeat_interleave(rep, 2),
                           cm.float().repeat_interleave(rep, 2), chunk=chunk)


@pytest.mark.parametrize("case", list(EMULATED.values()), ids=list(EMULATED))
def test_three_pass_decomposition_matches_the_chunked_scan(case):
    """Exact products: the kernel's passes (chunk states, state passing,
    output with C B^T per group) compute the reference's scan."""
    *shape, chunk = case
    x = _grouped_inputs(*shape)
    y, state = _kernel_emulated(*x, chunk, *[_exact_mm] * 4)
    y_ref, s_ref = _plain(*x, chunk)
    torch.testing.assert_close(y, y_ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(state, s_ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", list(EMULATED.values()), ids=list(EMULATED))
def test_float32_route_needs_three_tf32_products(case):
    """float32 inputs: 3xTF32 on all four products, with the kernel's
    operand split, stays within the 1e-4 tolerance of the plain version on y
    and the state; one TF32 product (10 mantissa bits) does not."""
    *shape, chunk = case
    x = _grouped_inputs(*shape)
    y_ref, s_ref = _plain(*x, chunk)
    errs = {}
    for products in (3, 1):
        y, state = _kernel_emulated(*x, chunk, *[_split_mm(_split_tf32, products)] * 4)
        errs[products] = (float((y - y_ref).abs().max()), float((state - s_ref).abs().max()))
    assert max(errs[3]) <= ATOL, errs
    assert errs[1][0] > 10 * ATOL, errs


def test_bf16_route_precision_plans():
    """bf16 inputs at mamba2-130m's widths, held as chip_smoke.py holds the
    kernel (y rounded to bf16 within atol 1e-2 + rtol 8e-3 of the plain
    version's, the state within 1e-4).  The kernel's plan, 3xTF32 with the
    exact bf16 operands unsplit, passes; so does plain bf16 C B^T with every
    float32 operand split into bf16 hi + lo; a single bf16 G * L does not."""
    *shape, chunk = EMULATED["mamba2"]
    x = [t.to(torch.bfloat16) for t in _grouped_inputs(*shape)]
    y_ref, s_ref = _plain(*x, chunk)
    y_ref = y_ref.to(torch.bfloat16).float()

    def over(plan):
        y, state = _kernel_emulated(*x, chunk, *plan)
        err = (y.to(torch.bfloat16).float() - y_ref).abs()
        return float((err - (1e-2 + 8e-3 * y_ref.abs())).max()), float((state - s_ref).abs().max())

    tf32, hi_lo, one = (_split_mm(_split_tf32, 3), _split_mm(_split_bf16, 3),
                        _split_mm(_split_bf16, 1))
    for plan in ((tf32,) * 4, (hi_lo, one, hi_lo, hi_lo)):
        y_over, s_err = over(plan)
        assert y_over <= 0 and s_err <= ATOL, (y_over, s_err)
    assert over((hi_lo, one, one, hi_lo))[0] > 0

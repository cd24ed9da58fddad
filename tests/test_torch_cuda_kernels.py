"""The hand-written CUDA kernels against their plain PyTorch versions on the
card.  Marked ``cuda``; they skip where no CUDA device is present.  Run them
on a GPU machine with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flash_attention import mha, mha_ref  # noqa: E402
from repro_torch.kernels.layernorm import layernorm, layernorm_ref  # noqa: E402
from repro_torch.kernels.lut_softmax import lut_softmax, lut_softmax_ref  # noqa: E402
from repro_torch.kernels.qmatmul import (  # noqa: E402
    qmatmul,
    qmatmul_int8,
    qmatmul_prequantized,
    qmatmul_ref,
)
from repro_torch.kernels.ssd_scan import ssd, ssd_chunked, ssd_with_state  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch import resolve_device

    return resolve_device("cuda")


@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("mode", ["safe", "lut"])
@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 24)])
def test_attention_kernel_matches_plain(dev, d, mode, causal, window):
    g = torch.Generator(device="cpu").manual_seed(d)
    q, k, v = (torch.randn(shape, generator=g).to(dev)
               for shape in ((2, 4, 100, d), (2, 2, 100, d), (2, 2, 100, d)))
    before = LAUNCHES["flash_attention"]
    out = mha(q, k, v, causal=causal, window=window, mode=mode)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    ref = mha_ref(q, k, v, causal=causal, window=window, mode=mode)
    if mode == "safe":  # float32 sums in another order, as the CPU parity tests
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
        return
    # lut: 1e-4, except rows where the other float order moves a table entry:
    # an exp flip moves an output by at most 1.6 % of |v_j - out|, a 1/x flip
    # by 0.8 % of |out|; such rows must be under 1 % of the rows
    err = (out - ref).abs()
    vmax = torch.repeat_interleave(v.abs().amax(dim=-2, keepdim=True), 2, dim=1)
    assert (err <= 1e-4 + 0.016 * (ref.abs() + vmax)).all()
    assert (err > 1e-4).any(dim=-1).float().mean() <= 0.01


def test_attention_kernel_bf16_and_kv_len(dev):
    g = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (torch.randn(1, 2, 70, 32, generator=g).to(dev, torch.bfloat16) for _ in range(3))
    out = mha(q, k, v, causal=True, kv_len=61)
    ref = mha_ref(q, k, v, causal=True, kv_len=61)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=0)


def _ulp(ref):
    """One ulp of ref's dtype at each |ref| (0 for float32: its tolerance is
    the atol alone)."""
    bits = {torch.bfloat16: 7, torch.float16: 10}.get(ref.dtype)
    if bits is None:
        return torch.zeros_like(ref, dtype=torch.float32)
    r = ref.float().abs().clamp_min(torch.finfo(ref.dtype).tiny)
    return torch.exp2(torch.floor(torch.log2(r)) - bits)


def _assert_layernorm_close(out, ref, beta, use_lut):
    """1e-5 (float order) plus one ulp of a 16-bit output (its one
    rounding); in LUT mode a row whose variance sits at a table tie may take
    the neighbouring 1/sqrt entry, 0.27 % away, on at most 1 % of the rows."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    err = (out.float() - ref.float()).abs()
    limit = 1e-5 + _ulp(ref)
    flip = 0.003 * (ref.float().abs() + beta.float().abs()) if use_lut else 0.0
    assert (err <= limit + flip).all()
    assert (err > limit).reshape(-1, err.shape[-1]).any(dim=-1).float().mean() <= 0.01


@pytest.mark.parametrize("rows,k", [(120, 64), (800, 32), (33, 200), (9, 33), (1100, 768),
                                    (64, 4096), (1100, 4096), (16, 8192), (1100, 8192)])
@pytest.mark.parametrize("dtype,param_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float32),
    (torch.float16, torch.float16)])
@pytest.mark.parametrize("use_lut", [False, True])
@pytest.mark.parametrize("rms", [False, True])
def test_layernorm_kernel_matches_plain(dev, rows, k, dtype, param_dtype, use_lut, rms):
    """x in float32, bf16 or fp16 and gamma / beta in float32 or x's dtype,
    at the lane-team (K 32, 64), warp (K 200, 768; K 33: single elements)
    and block (K 4096, 8192; up to 1024 rows: 8 elements per thread)
    instances: one launch, x's dtype out.  RMSNorm is handed beta too, and
    ignores it."""
    g = torch.Generator(device="cpu").manual_seed(rows + k)
    x = (torch.randn(rows, k, generator=g) * 3).to(dev, dtype)
    gamma, beta = (torch.randn(k, generator=g).to(dev, param_dtype) for _ in range(2))
    before = LAUNCHES["layernorm"]
    out = layernorm(x, gamma, beta, use_lut=use_lut, rms=rms)
    torch.cuda.synchronize()
    assert LAUNCHES["layernorm"] == before + 1
    ref = layernorm_ref(x, gamma, beta, use_lut=use_lut, rms=rms)
    _assert_layernorm_close(out, ref, beta, use_lut)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("what", ["x", "gamma"])
def test_layernorm_kernel_misaligned(dev, dtype, what):
    """A view one element off 16-byte alignment takes the single-element
    instances."""
    g = torch.Generator(device="cpu").manual_seed(5)
    flat = torch.randn(64 * 96 + 1, generator=g).to(dev, dtype)
    x = flat[1:].view(64, 96) if what == "x" else flat[:-1].view(64, 96)
    gflat = torch.randn(97, generator=g).to(dev, dtype)
    gamma = gflat[1:] if what == "gamma" else gflat[:96]
    beta = torch.randn(96, generator=g).to(dev, dtype)
    before = LAUNCHES["layernorm"]
    out = layernorm(x, gamma, beta)
    torch.cuda.synchronize()
    assert LAUNCHES["layernorm"] == before + 1
    _assert_layernorm_close(out, layernorm_ref(x, gamma, beta), beta, False)


@pytest.mark.parametrize("bits", [(12, 6), (16, 6)])
@pytest.mark.parametrize("rms", [False, True])
def test_layernorm_kernel_fixed_precision_and_no_beta(dev, bits, rms):
    """precision= snaps the kernel's output onto the ap_fixed grid (one grid
    step apart where the float order crosses a midpoint); a LayerNorm
    without beta is one with zeros."""
    from repro_torch.core import precision

    prec = precision.fixed(*bits)
    step = prec.fixed_cfg().step
    g = torch.Generator(device="cpu").manual_seed(bits[0])
    x = (torch.randn(800, 32, generator=g) * 3).to(dev)
    gamma = torch.randn(32, generator=g).to(dev)
    before = LAUNCHES["layernorm"]
    out = layernorm(x, gamma, precision=prec, rms=rms)
    torch.cuda.synchronize()
    assert LAUNCHES["layernorm"] == before + 1
    assert torch.equal(out, torch.round(out / step) * step)
    ref = layernorm_ref(x, gamma, precision=prec, rms=rms)
    err = (out - ref).abs()
    assert (err <= 1e-5 + step).all() and (err > 1e-5).float().mean() <= 0.01
    if not rms:
        zeros = layernorm(x, gamma, torch.zeros(32, device=dev))
        assert torch.equal(layernorm(x, gamma), zeros)


def _assert_attention_close(out, ref, v, dtype, mode, group):
    """The existing tolerances: float32 safe 2e-5; lut 1e-4 except rows where
    the other float order moves a table entry (at most 1.6 % of |v_j - out|,
    under 1 % of the rows); bf16 atol 1e-2 + rtol 8e-3 (P is rounded to bf16
    before P V on the tensor cores, as the output is)."""
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=8e-3)
    elif mode == "safe":
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    else:
        err = (out - ref).abs()
        vmax = torch.repeat_interleave(v.abs().amax(dim=-2, keepdim=True), group, dim=1)
        assert (err <= 1e-4 + 0.016 * (ref.abs() + vmax)).all()
        assert (err > 1e-4).any(dim=-1).float().mean() <= 0.01


# (Lq, Lkv, kv_len) for a length L: square; keys past kv_len masked; fewer
# queries than keys (causal stays top-left aligned, as the plain version)
def _lengths(length, layout):
    if layout == "square":
        return length, length, None
    if layout == "kv_len":
        return length, length, max(1, length - 13)
    return length, length + 37, None


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype,mode", [(torch.float32, "safe"), (torch.float32, "lut"),
                                        (torch.bfloat16, "safe")])
@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 256)])
@pytest.mark.parametrize("hq,hkv", [(32, 8), (8, 8)])
@pytest.mark.parametrize("length", [1, 77, 1000, 1024])
@pytest.mark.parametrize("layout", ["square", "kv_len", "lq_below_lkv"])
def test_attention_tensor_core_path(dev, d, dtype, mode, causal, window, hq, hkv, length,
                                    layout):
    """head_dim 64 / 128: bf16 on wgmma, float32 as 3xTF32, K/V by TMA."""
    lq, lkv, kv_len = _lengths(length, layout)
    g = torch.Generator(device="cpu").manual_seed(length + d + hq)
    q = torch.randn(1, hq, lq, d, generator=g).to(dev, dtype)
    k, v = (torch.randn(1, hkv, lkv, d, generator=g).to(dev, dtype) for _ in range(2))
    before = LAUNCHES["flash_attention"]
    out = mha(q, k, v, causal=causal, window=window, mode=mode, kv_len=kv_len)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = mha_ref(q, k, v, causal=causal, window=window, mode=mode, kv_len=kv_len)
    _assert_attention_close(out, ref, v, dtype, mode, hq // hkv)


@pytest.mark.parametrize("d", [8, 16, 32])
@pytest.mark.parametrize("dtype,mode", [(torch.float32, "safe"), (torch.float32, "lut"),
                                        (torch.bfloat16, "safe")])
@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 24)])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 2)])
@pytest.mark.parametrize("length", [1, 15, 50, 100, 113, 1024])
@pytest.mark.parametrize("layout", ["square", "kv_len", "lq_below_lkv"])
def test_attention_small_head_tensor_core_path(dev, d, dtype, mode, causal, window, hq, hkv,
                                               length, layout):
    """head_dim 8 / 16 / 32: a warp per 16 query rows, heads packed, K/V
    staged per head; 3xTF32 or bf16 on mma.sync."""
    lq, lkv, kv_len = _lengths(length, layout)
    g = torch.Generator(device="cpu").manual_seed(length + d + hkv)
    q = torch.randn(1, hq, lq, d, generator=g).to(dev, dtype)
    k, v = (torch.randn(1, hkv, lkv, d, generator=g).to(dev, dtype) for _ in range(2))
    before = LAUNCHES["flash_attention"]
    out = mha(q, k, v, causal=causal, window=window, mode=mode, kv_len=kv_len)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = mha_ref(q, k, v, causal=causal, window=window, mode=mode, kv_len=kv_len)
    _assert_attention_close(out, ref, v, dtype, mode, hq // hkv)


@pytest.mark.parametrize("length", [15, 50, 100])
@pytest.mark.parametrize("dtype,mode", [(torch.float32, "safe"), (torch.float32, "lut"),
                                        (torch.bfloat16, "safe")])
@pytest.mark.parametrize("batch,hq,hkv", [(3, 5, 5), (3, 6, 2), (303, 7, 7), (45, 8, 4)])
def test_attention_small_head_packing(dev, length, dtype, mode, batch, hq, hkv):
    """Blocks that straddle heads: B * H * ceil(L / 16) is not a multiple of
    the warps per block (4 for the small grids, 8 for the large ones).
    Every key/value head has its own random values and, on top, its own
    offset among 8 neighbours (a block spans at most 8 heads), so a row that
    read another head's K or V would show."""
    g = torch.Generator(device="cpu").manual_seed(length + batch)
    q = torch.randn(batch, hq, length, 8, generator=g)
    k = torch.randn(batch, hkv, length, 8, generator=g)
    offset = 0.5 * (torch.arange(batch * hkv) % 8).float().reshape(batch, hkv, 1, 1)
    v = torch.randn(batch, hkv, length, 8, generator=g) + offset
    q, k, v = (t.to(dev, dtype) for t in (q, k, v))
    before = LAUNCHES["flash_attention"]
    out = mha(q, k, v, mode=mode)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    _assert_attention_close(out, mha_ref(q, k, v, mode=mode), v, dtype, mode, hq // hkv)


@pytest.mark.parametrize("d", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_small_head_misaligned(dev, d, dtype):
    """Contiguous views one element off 16-byte alignment (q alone, then
    q, k and v) run, staged by element copies, and match rather than
    raise."""
    g = torch.Generator(device="cpu").manual_seed(d)

    def view(*shape):
        n = int(np.prod(shape))
        return torch.randn(n + 1, generator=g).to(dev, dtype)[1:].view(*shape)

    q, k, v = view(2, 4, 100, d), view(2, 2, 100, d), view(2, 2, 100, d)
    k_al, v_al = k.clone(), v.clone()
    before = LAUNCHES["flash_attention"]
    outs = [mha(q, k_al, v_al, causal=True), mha(q, k, v, causal=True, mode="lut")]
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 2
    _assert_attention_close(outs[0], mha_ref(q, k, v, causal=True), v, dtype, "safe", 2)
    _assert_attention_close(outs[1], mha_ref(q, k, v, causal=True, mode="lut"), v, dtype,
                            "lut", 2)


def test_attention_wrapper_rejects_misaligned_tma_input(dev):
    """TMA needs 16-byte aligned tensors: a contiguous view 4 bytes off is refused."""
    flat = torch.randn(2 * 4 * 16 * 64 + 1, device=dev)
    x = flat[1:].view(2, 4, 16, 64)
    with pytest.raises(ValueError, match="aligned"):
        mha(x, x, x)


def test_cuda_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.randn(4, 2, 10, 192, device=dev)  # above the largest head_dim, 128
    with pytest.raises(ValueError, match="head_dim"):
        mha(x, x, x)
    x = torch.randn(4, 2, 10, 8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        mha(x.transpose(1, 2), x.transpose(1, 2), x.transpose(1, 2))
    with pytest.raises(ValueError, match="float32"):
        layernorm(torch.randn(4, 8, device=dev, dtype=torch.float64),
                  torch.ones(8, device=dev), torch.zeros(8, device=dev))
    with pytest.raises(ValueError, match="float32"):  # bf16 params for a float16 x
        layernorm(torch.randn(4, 8, device=dev, dtype=torch.float16),
                  torch.ones(8, device=dev, dtype=torch.bfloat16))


@pytest.mark.parametrize("d", [12, 14, 80, 96])
@pytest.mark.parametrize("dtype,mode", [(torch.float32, "safe"), (torch.float32, "lut"),
                                        (torch.bfloat16, "safe")])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_pads_other_head_dims(dev, d, dtype, mode, causal):
    """head_dim 12 / 14 run at 16, 80 / 96 at 128 (zero-padded, sliced back),
    one kernel launch, the existing tolerances."""
    g = torch.Generator(device="cpu").manual_seed(d)
    q = torch.randn(2, 4, 100, d, generator=g).to(dev, dtype)
    k, v = (torch.randn(2, 2, 100, d, generator=g).to(dev, dtype) for _ in range(2))
    before = LAUNCHES["flash_attention"]
    out = mha(q, k, v, causal=causal, mode=mode)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()
    ref = mha_ref(q, k, v, causal=causal, mode=mode)
    _assert_attention_close(out, ref, v, dtype, mode, 2)


def _assert_mla_close(out, ref, v, dtype, mode, group):
    """bf16: atol 1e-2 + rtol 8e-3; float32: 2e-5 (safe), 1e-4 (lut).  lut:
    rows where the other float order moves a table entry (at most 1.6 % of
    |v_j - out|) on under 1 % of the rows."""
    err = (out.float() - ref.float()).abs()
    limit = (1e-2 + 8e-3 * ref.float().abs() if dtype == torch.bfloat16
             else torch.full_like(err, 2e-5 if mode == "safe" else 1e-4))
    if mode == "safe":
        assert (err <= limit).all(), float(err.max())
        return
    vmax = torch.repeat_interleave(v.float().abs().amax(dim=-2, keepdim=True), group, dim=1)
    assert (err <= limit + 0.016 * (ref.float().abs() + vmax)).all()
    assert (err > limit).any(dim=-1).float().mean() <= 0.01


@pytest.mark.parametrize("dtype,mode", [(torch.float32, "safe"), (torch.float32, "lut"),
                                        (torch.bfloat16, "safe"), (torch.bfloat16, "lut")])
@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 256)])
@pytest.mark.parametrize("hq,hkv", [(40, 40), (8, 2)])
@pytest.mark.parametrize("length,kv_len", [(77, None), (1000, None), (1000, 768), (1000, 769),
                                           (1000, 640), (1000, 641)])
def test_attention_native_v_head_dim(dev, dtype, mode, causal, window, hq, hkv, length, kv_len):
    """MLA's (q/k 96, V 64) instance: one launch at the unpadded shapes, the
    output at V's head_dim; kv_len on a 64-key tile edge and one past it.
    With the window of 256, kv_len 640 / 641 leave rows 895 / 896 on with no
    key: in safe mode they give the mean of V over every key, as the plain
    version's softmax of a row masked everywhere; in lut mode 0, as there."""
    g = torch.Generator(device="cpu").manual_seed(length + hq + (kv_len or 0))
    q = torch.randn(2, hq, length, 96, generator=g).to(dev, dtype)
    k = torch.randn(2, hkv, length, 96, generator=g).to(dev, dtype)
    v = torch.randn(2, hkv, length, 64, generator=g).to(dev, dtype)
    before = LAUNCHES["flash_attention"]
    out = mha(q, k, v, causal=causal, window=window, mode=mode, kv_len=kv_len)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == (2, hq, length, 64) and out.is_contiguous()
    ref = mha_ref(q, k, v, causal=causal, window=window, mode=mode, kv_len=kv_len)
    _assert_mla_close(out, ref, v, dtype, mode, hq // hkv)


@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype,mode", [(torch.float32, "safe"), (torch.float32, "lut"),
                                        (torch.bfloat16, "safe")])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 2)])
def test_attention_rows_that_see_no_key(dev, d, dtype, mode, causal, hq, hkv):
    """A window that ends before kv_len on the (64, 64), (128, 128) and
    head_dim 8-32 routes: rows q >= kv_len + window - 1 (here 189-299) see
    no key.  safe: they give the mean of V over every key (kv_len padding
    included), as mha_ref; lut: 0, as mha_ref.  The other rows keep the
    existing tolerances."""
    length, kv_len, window = 300, 150, 40
    g = torch.Generator(device="cpu").manual_seed(d + hq + hkv)
    q = torch.randn(2, hq, length, d, generator=g).to(dev, dtype)
    k, v = (torch.randn(2, hkv, length, d, generator=g).to(dev, dtype) for _ in range(2))
    before = LAUNCHES["flash_attention"]
    out = mha(q, k, v, causal=causal, window=window, mode=mode, kv_len=kv_len)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    ref = mha_ref(q, k, v, causal=causal, window=window, mode=mode, kv_len=kv_len)
    _assert_attention_close(out, ref, v, dtype, mode, hq // hkv)
    keyless = out[:, :, kv_len + window - 1:].float()
    if mode == "lut":
        assert torch.all(keyless == 0)
        return
    mean = torch.repeat_interleave(v.float().mean(dim=2, keepdim=True), hq // hkv, dim=1)
    tol = 1e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(keyless, mean.expand_as(keyless), atol=tol, rtol=0)
    assert float(mean.abs().max()) > 0.01  # the mean is not the old zero


@pytest.mark.parametrize("dtype,mode", [(torch.float32, "safe"), (torch.float32, "lut"),
                                        (torch.bfloat16, "safe")])
@pytest.mark.parametrize("b,hq,hkv,length,d,causal", [
    (2, 14, 2, 512, 64, True),  # internvl2-1b: 7 query heads per KV head
    (2, 16, 16, 512, 80, False),  # hubert-xlarge: head_dim 80 (padded to 128), an encoder
    (1, 32, 32, 256, 128, True),  # zamba2-1.2b's shared block: MHA at 128
])
def test_attention_at_the_frontend_and_hybrid_shapes(dev, dtype, mode, b, hq, hkv, length, d,
                                                     causal):
    """The attention shapes of internvl2-1b, hubert-xlarge and zamba2-1.2b's
    shared block, at a shorter length: one launch, the existing tolerances."""
    g = torch.Generator(device="cpu").manual_seed(hq + d)
    q = torch.randn(b, hq, length, d, generator=g).to(dev, dtype)
    k, v = (torch.randn(b, hkv, length, d, generator=g).to(dev, dtype) for _ in range(2))
    before = LAUNCHES["flash_attention"]
    out = mha(q, k, v, causal=causal, mode=mode)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    _assert_attention_close(out, mha_ref(q, k, v, causal=causal, mode=mode), v, dtype, mode,
                            hq // hkv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("what", ["q", "k", "v"])
def test_attention_native_v_head_dim_rejects_unaligned_and_unknown_pairs(dev, dtype, what):
    """TMA needs 16-byte aligned tensors: a contiguous view one element off
    is refused, as is a (q/k, V) pair no instance takes."""
    g = torch.Generator(device="cpu").manual_seed(3)
    shapes = {"q": (1, 4, 70, 96), "k": (1, 4, 70, 96), "v": (1, 4, 70, 64)}
    t = {n: torch.randn(*sh, generator=g).to(dev, dtype) for n, sh in shapes.items()}
    flat = torch.randn(t[what].numel() + 1, generator=g).to(dev, dtype)
    t[what] = flat[1:].view(shapes[what])
    with pytest.raises(ValueError, match="aligned"):
        mha(t["q"], t["k"], t["v"], causal=True)
    with pytest.raises(ValueError, match="no kernel instance"):
        mha(t["q"].clone(), t["k"].clone(), t["v"][..., :32].contiguous())


def _codes(g, m, k, n):
    x = torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=g, dtype=torch.int8)
    xs = torch.rand(m, 1, generator=g) * 0.05 + 1e-3
    ws = torch.rand(1, n, generator=g) * 0.05 + 1e-3
    return x, w, xs, ws


@pytest.mark.parametrize("m,k,n", [
    (8, 16, 8), (100, 300, 200), (128, 128, 128), (7, 130, 65), (1, 256, 512),
    (1000, 16, 16), (600, 64, 64), (700, 32, 32), (257, 48, 40), (300, 1024, 24),
    (33, 40, 4096), (4099, 64, 36), (5, 0, 8),
])
def test_qmatmul_kernel_bitwise(dev, m, k, n):
    g = torch.Generator(device="cpu").manual_seed(m * 7 + k + n)
    x, w, xs, ws = (t.to(dev) for t in _codes(g, m, k, n))
    before = LAUNCHES["qmatmul"]
    out = qmatmul_int8(x, w, xs, ws)
    torch.cuda.synchronize()
    assert LAUNCHES["qmatmul"] == before + 1
    # exact int32 sums and the same float epilogue: bitwise equal
    ref = qmatmul_ref(x, w, xs, ws)
    assert torch.equal(out, ref)
    assert torch.equal(out.cpu(), qmatmul_ref(*(t.cpu() for t in (x, w, xs, ws))))


@pytest.mark.parametrize("m", [1, 63, 65, 1000])
@pytest.mark.parametrize("k", [16, 48, 64, 80, 130])
@pytest.mark.parametrize("n", [8, 24, 30, 64, 65, 80, 200])
def test_qmatmul_kernel_route_edges_bitwise(dev, m, k, n):
    """Both routes at their edges (ragged M, a 16-deep K tail of a 32-deep
    step, N off every tile, the K / N = 64 threshold), with and without the
    K-major weight copy: bitwise equal to the plain version, through the
    route ``route`` names."""
    from repro_torch.kernels.qmatmul import ROUTES, route

    g = torch.Generator(device="cpu").manual_seed(m + 3 * k + 7 * n)
    x, w, xs, ws = (t.to(dev) for t in _codes(g, m, k, n))
    ref = qmatmul_ref(x, w, xs, ws)
    for w_kmajor in (None, w.t().contiguous()):
        before = ROUTES[route(k, n)]
        out = qmatmul_int8(x, w, xs, ws, w_kmajor=w_kmajor)
        torch.cuda.synchronize()
        assert ROUTES[route(k, n)] == before + 1
        assert torch.equal(out, ref)


@pytest.mark.parametrize("m,k,n", [(1024, 4096, 4096), (4096, 4096, 4096), (100, 48, 4096)])
@pytest.mark.parametrize("r", [1, 2, 4, 8])
def test_qmatmul_kernel_wide_shapes_take_wgmma_for_every_r(dev, m, k, n, r):
    """granite-8b's projection and 4096^3 launch the wgmma route, bitwise
    equal for every reuse factor, with the K-major copy as the streaming MHA
    hands it."""
    from repro_torch.kernels.qmatmul import ROUTES

    g = torch.Generator(device="cpu").manual_seed(k + n + r)
    x, w, xs, ws = (t.to(dev) for t in _codes(g, m, k, n))
    before = ROUTES["wide"]
    out = qmatmul_int8(x, w, xs, ws, grid_k=r, w_kmajor=w.t().contiguous())
    torch.cuda.synchronize()
    assert ROUTES["wide"] == before + 1
    assert torch.equal(out, qmatmul_ref(x, w, xs, ws))


@pytest.mark.parametrize("r", [1, 2, 4, 8])
def test_qmatmul_kernel_reuse_factor_bitwise(dev, r):
    g = torch.Generator(device="cpu").manual_seed(3)
    x, w, xs, ws = (t.to(dev) for t in _codes(g, 64, 1024, 96))
    base = qmatmul_int8(x, w, xs, ws, grid_k=1)
    assert torch.equal(qmatmul_int8(x, w, xs, ws, grid_k=r), base)
    xf, wf = (torch.randn(64, 512, generator=g).to(dev), torch.randn(512, 96, generator=g).to(dev))
    assert torch.equal(qmatmul(xf, wf, reuse_factor=r), qmatmul(xf, wf))


def test_qmatmul_kernel_int32_exact(dev):
    rng = np.random.default_rng(7)
    xq = rng.integers(-128, 128, (64, 4096), dtype=np.int8)
    wq = rng.integers(-128, 128, (4096, 64), dtype=np.int8)
    out = qmatmul_int8(torch.from_numpy(xq).to(dev), torch.from_numpy(wq).to(dev),
                       torch.ones(64, 1, device=dev), torch.ones(1, 64, device=dev))
    expected = xq.astype(np.int64) @ wq.astype(np.int64)
    np.testing.assert_array_equal(out.cpu().numpy(), expected.astype(np.float32))


def test_qmatmul_prequantized_per_tensor(dev):
    from repro_torch.core import quant

    g = torch.Generator(device="cpu").manual_seed(5)
    x, w = torch.randn(33, 40, generator=g).to(dev), torch.randn(40, 24, generator=g).to(dev)
    for ax, aw in ((0, 1), (None, None), (0, None)):
        xq, wq = quant.quantize_int8(x, axis=ax), quant.quantize_int8(w, axis=aw)
        out = qmatmul_prequantized(xq, wq)
        xs = xq.scale.reshape(-1, 1).expand(33, 1)
        ws = wq.scale.reshape(1, -1).expand(1, 24)
        assert torch.equal(out, qmatmul_ref(xq.values, wq.values, xs, ws))


@pytest.mark.parametrize("shape", [(64, 64), (2, 4, 48, 48), (1, 16), (128, 100), (3, 5, 7),
                                   (1000, 15), (1000, 50), (200, 1024), (9, 3)])
@pytest.mark.parametrize("fixed", [False, True])
def test_lut_softmax_kernel_matches_plain(dev, shape, fixed):
    from repro_torch.core import fixed_point, precision

    prec = precision.fixed(12, 6) if fixed else None
    g = torch.Generator(device="cpu").manual_seed(sum(shape))
    x = (torch.randn(shape, generator=g) * 3).to(dev)
    before = LAUNCHES["lut_softmax"]
    out = lut_softmax(x, precision=prec)
    torch.cuda.synchronize()
    assert LAUNCHES["lut_softmax"] == before + 1
    ref = lut_softmax_ref(x)
    if prec is not None:
        ref = fixed_point.quantize(ref, prec.fixed_cfg())
    # The exp entries are the same (same index arithmetic on the same score);
    # the row sums are taken in another order, so a row at a 1/x-table tie
    # may take the neighbouring entry, 0.76 % away (and then cross one
    # ap_fixed<12,6> level, 2^-6).  Such rows must be under 1 % of the rows.
    err = (out - ref).abs()
    step = 0.008 * ref.abs() + (2.0 ** -6 if fixed else 0.0)
    assert (err <= step).all()
    assert (err > 0).reshape(-1, shape[-1]).any(dim=-1).float().mean() <= 0.01


def test_streaming_mha_on_the_card(dev):
    from repro_torch.core.streaming_mha import quantize_mha_params, streaming_mha

    g = torch.Generator(device="cpu").manual_seed(0)
    d, h = 32, 4
    ws = [torch.randn(d, d, generator=g) / d ** 0.5 for _ in range(4)]
    bs = [0.1 * torch.randn(d, generator=g) for _ in range(4)]
    x = torch.randn(3, 20, d, generator=g)
    p_cpu = quantize_mha_params(*ws, *bs)
    p_dev = quantize_mha_params(*(t.to(dev) for t in ws), *(t.to(dev) for t in bs))
    for mode in ("safe", "lut"):
        before = dict(LAUNCHES)
        out = streaming_mha(x.to(dev), p_dev, n_heads=h, causal=True, softmax_mode=mode)
        torch.cuda.synchronize()
        assert LAUNCHES["qmatmul"] - before.get("qmatmul", 0) == 4
        assert LAUNCHES["flash_attention"] - before.get("flash_attention", 0) == 1
        ref = streaming_mha(x, p_cpu, n_heads=h, causal=True, softmax_mode=mode)
        # float order in attention may move a stage-4 int8 code by one step
        torch.testing.assert_close(out.cpu(), ref, atol=5e-3, rtol=0)


def test_quantizer_and_stage1_bitwise_across_devices(dev):
    """Row scales divide exactly on the card too (no reciprocal multiply),
    so the int8 codes, scales and a stage-1 projection are bitwise equal to
    the CPU's, and so are the plain version's exp-table indices."""
    from repro_torch.core import lut, quant
    from repro_torch.core.streaming_mha import int8_linear

    g = torch.Generator(device="cpu").manual_seed(11)
    x = torch.randn(4096, 96, generator=g) * torch.rand(4096, 1, generator=g) * 5
    w = quant.quantize_int8(torch.randn(96, 64, generator=g), axis=1)
    for axis in (0, 1, None):
        a, b = quant.quantize_int8(x, axis=axis), quant.quantize_int8(x.to(dev), axis=axis)
        assert torch.equal(a.values, b.values.cpu()) and torch.equal(a.scale, b.scale.cpu())
    w_dev = quant.QTensor(w.values.to(dev), w.scale.to(dev), w.axis)
    assert torch.equal(int8_linear(x, w, None), int8_linear(x.to(dev), w_dev, None).cpu())
    # the linear exp table (a log table's log2 may differ by ulps at ties)
    assert torch.equal(lut.lut_index(x, lut.EXP_SPEC), lut.lut_index(x.to(dev), lut.EXP_SPEC).cpu())


def test_int8_and_lut_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(8, 16, dtype=torch.int8, device=dev)
    w = torch.zeros(16, 8, dtype=torch.int8, device=dev)
    xs, ws = torch.ones(8, 1, device=dev), torch.ones(1, 8, device=dev)
    with pytest.raises(ValueError, match="int8"):
        qmatmul_int8(x.float(), w, xs, ws)
    with pytest.raises(ValueError, match="float32"):
        qmatmul_int8(x, w, xs.double(), ws)
    with pytest.raises(ValueError, match="contiguous"):
        qmatmul_int8(x, torch.zeros(8, 16, dtype=torch.int8, device=dev).t(), xs, ws)
    with pytest.raises(ValueError, match="devices"):
        qmatmul_int8(x, w.cpu(), xs, ws)
    with pytest.raises(ValueError, match="float32"):
        lut_softmax(torch.zeros(4, 8, device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        lut_softmax(torch.zeros(8, 4, device=dev).t())


def _ssd_inputs(g, b, l, h, p, n, groups=None):
    """The JAX kernel test's distributions; B and C per group when given."""
    gb = h if groups is None else groups
    return (torch.randn(b, l, h, p, generator=g) * 0.5,
            -torch.randn(b, l, h, generator=g).abs() * 0.3,
            torch.randn(b, l, gb, n, generator=g) * 0.5,
            torch.randn(b, l, gb, n, generator=g) * 0.5)


def _ssd_plain(xdt, a, bm, cm, chunk):
    rep = xdt.shape[2] // bm.shape[2]
    return ssd_chunked(xdt.float(), a.float(), bm.float().repeat_interleave(rep, 2),
                       cm.float().repeat_interleave(rep, 2), chunk=min(chunk, xdt.shape[1]))


# (b, l, h, p, n, groups, chunk): the JAX kernel test's sweep, the reduced
# config, the published widths (g = 1, as mamba_apply hands B and C over);
# then the edges of the kernel's tiles: l < chunk (q 12), P 8 / 16 / 128
# against N 16 / 24 / 128 (zero-padded to 32 in shared memory), 2 groups of
# 8 heads, 23 heads (prime: no head tile but 1 and 23 divides them), and 64
# chunks at batch 1 (a long chain through the state pass)
SSD_CASES = [
    (2, 64, 3, 16, 24, None, 8), (2, 64, 3, 16, 24, None, 16), (2, 64, 3, 16, 24, None, 32),
    (2, 64, 3, 16, 24, None, 64), (1, 32, 1, 8, 8, None, 32), (2, 128, 2, 32, 16, None, 32),
    (1, 64, 4, 64, 64, None, 32), (2, 64, 8, 8, 16, 1, 16), (1, 256, 24, 64, 128, 1, 64),
    (2, 128, 24, 64, 128, 2, 64), (1, 96, 3, 128, 128, None, 32),
    (2, 12, 3, 16, 24, None, 64), (2, 128, 2, 8, 128, 1, 64), (1, 128, 4, 16, 24, 2, 32),
    (2, 192, 2, 128, 16, 1, 64), (1, 256, 3, 128, 128, 1, 64), (2, 128, 8, 64, 24, 1, 16),
    (1, 128, 8, 32, 64, 2, 32), (1, 2048, 23, 64, 128, 1, 64), (1, 4096, 4, 64, 128, 1, 64),
]


@pytest.mark.parametrize("b,l,h,p,n,groups,chunk", SSD_CASES)
def test_ssd_scan_kernel_matches_plain(dev, b, l, h, p, n, groups, chunk):
    g = torch.Generator(device="cpu").manual_seed(l + p + n)
    x = [t.to(dev) for t in _ssd_inputs(g, b, l, h, p, n, groups)]
    before = LAUNCHES["ssd_scan"]
    y, state = ssd_with_state(*x, chunk=chunk)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == before + 1
    y_ref, s_ref = _ssd_plain(*x, chunk)
    # float32 sums in another order: the JAX kernel test's 1e-4
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(state, s_ref, atol=1e-4, rtol=0)
    assert torch.equal(ssd(*x, chunk=chunk) if groups is None else y, y)


@pytest.mark.parametrize("l", [1, 3, 12, 50])
def test_ssd_scan_kernel_length_below_chunk(dev, l):
    g = torch.Generator(device="cpu").manual_seed(l)
    x = [t.to(dev) for t in _ssd_inputs(g, 2, l, 3, 16, 24)]
    y, state = ssd_with_state(*x, chunk=64)
    y_ref, s_ref = _ssd_plain(*x, 64)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(state, s_ref, atol=1e-4, rtol=0)


def test_ssd_scan_kernel_bf16_and_strong_decay(dev):
    g = torch.Generator(device="cpu").manual_seed(1)
    x = [t.to(dev) for t in _ssd_inputs(g, 2, 128, 4, 64, 128, 1)]
    xb = [t.to(torch.bfloat16) for t in x]
    y, state = ssd_with_state(*xb, chunk=64)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    y_ref, s_ref = _ssd_plain(*xb, 64)  # the same bf16 inputs, in float32
    torch.testing.assert_close(y.float(), y_ref.to(torch.bfloat16).float(), atol=1e-2, rtol=8e-3)
    torch.testing.assert_close(state, s_ref, atol=1e-4, rtol=0)
    # a * 50: exp(cs_i - cs_j) underflows, never overflows: finite, as plain
    strong = (x[0], x[1] * 50.0, x[2], x[3])
    y, state = ssd_with_state(*strong, chunk=64)
    y_ref, s_ref = _ssd_plain(*strong, 64)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(state, s_ref, atol=1e-4, rtol=0)


def test_ssd_scan_kernel_heads_read_their_own_decay_and_state(dev):
    """Head i's inputs and decay scaled by i + 1: a head that read another's
    decay, chunk state or scratch slot would be far off.  |y| reaches ~110,
    so float32 products accumulated in long tensor-core chains would show
    here too."""
    g = torch.Generator(device="cpu").manual_seed(3)
    xdt, a, bm, cm = _ssd_inputs(g, 2, 256, 6, 64, 128, 1)
    scale = torch.arange(1, 7, dtype=torch.float32)
    x = [t.to(dev) for t in (xdt * scale[:, None], a * scale, bm, cm)]
    before = LAUNCHES["ssd_scan"]
    y, state = ssd_with_state(*x, chunk=64)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == before + 1
    y_ref, s_ref = _ssd_plain(*x, 64)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(state, s_ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("decay", [1.0, 50.0])
def test_ssd_scan_kernel_bf16_at_mamba_widths(dev, decay):
    """bf16 at mamba2-130m's widths (24 heads, P 64, N 128, one group), and
    under strong decay (a * 50)."""
    g = torch.Generator(device="cpu").manual_seed(5)
    xdt, a, bm, cm = _ssd_inputs(g, 1, 256, 24, 64, 128, 1)
    xb = [t.to(dev, torch.bfloat16) for t in (xdt, a * decay, bm, cm)]
    before = LAUNCHES["ssd_scan"]
    y, state = ssd_with_state(*xb, chunk=64)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == before + 1
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()
    y_ref, s_ref = _ssd_plain(*xb, 64)  # the same bf16 inputs, in float32
    torch.testing.assert_close(y.float(), y_ref.to(torch.bfloat16).float(), atol=1e-2, rtol=8e-3)
    torch.testing.assert_close(state, s_ref, atol=1e-4, rtol=0)


def test_ssd_scan_wrapper_rejects_what_the_kernel_does_not_take(dev):
    g = torch.Generator(device="cpu").manual_seed(2)
    x = [t.to(dev) for t in _ssd_inputs(g, 1, 128, 2, 16, 16)]
    with pytest.raises(ValueError, match="chunk <= 64"):
        ssd(*x, chunk=128)
    big_p = [t.to(dev) for t in _ssd_inputs(g, 1, 16, 1, 136, 16)]
    with pytest.raises(ValueError, match="P <= 128"):
        ssd(*big_p, chunk=16)
    big_n = [t.to(dev) for t in _ssd_inputs(g, 1, 16, 1, 16, 136)]
    with pytest.raises(ValueError, match="N <= 128"):
        ssd(*big_n, chunk=16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd(*x, chunk=48)
    with pytest.raises(ValueError, match="contiguous"):
        ssd(x[0].transpose(1, 2).contiguous().transpose(1, 2), *x[1:], chunk=32)
    with pytest.raises(ValueError, match="one type"):
        ssd(x[0], x[1].double(), *x[2:], chunk=32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ssd(*(t.half() for t in x), chunk=32)


def test_mamba_lm_on_the_card(dev):
    """The reduced mamba2-130m: prefill launches the kernel once per layer
    and the norm kernel 2 per layer + 1; decode launches no SSD kernel; the
    logits match the CPU path on the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.params import map_leaves

    cfg = get_config("mamba2-130m", reduced=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params_dev = map_leaves(lambda _, t: t.to(dev), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=torch.Generator().manual_seed(1))
    cache_cpu = lm.init_caches(cfg, 2, 17, device="cpu")
    cache_dev = lm.init_caches(cfg, 2, 17, device=dev)
    before = dict(LAUNCHES)
    last, cache_dev = lm.prefill(params_dev, cfg, {"tokens": toks[:, :16]}, cache_dev, device=dev)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] - before.get("ssd_scan", 0) == cfg.n_layers
    assert LAUNCHES["layernorm"] - before.get("layernorm", 0) == 2 * cfg.n_layers + 1
    ref, cache_cpu = lm.prefill(params, cfg, {"tokens": toks[:, :16]}, cache_cpu, device="cpu")
    torch.testing.assert_close(last.cpu(), ref, atol=2e-4, rtol=0)
    before = dict(LAUNCHES)
    last, _ = lm.decode_step(params_dev, cfg, toks[:, 16:].to(dev), torch.full((2,), 16),
                             cache_dev, device=dev)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == before.get("ssd_scan", 0)
    assert LAUNCHES["layernorm"] - before.get("layernorm", 0) == 2 * cfg.n_layers + 1
    ref, _ = lm.decode_step(params, cfg, toks[:, 16:], torch.full((2,), 16), cache_cpu,
                            device="cpu")
    torch.testing.assert_close(last.cpu(), ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("name", ["granite-8b", "minicpm-2b", "starcoder2-7b"])
def test_dense_lm_on_the_card(dev, name):
    """The reduced dense configs (starcoder2-7b's rolling buffer included):
    prefill launches the attention kernel once per layer and the norm kernel
    2 per layer + 1; decode launches no attention kernel; logits and caches
    match the CPU path on the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.params import map_leaves

    cfg = get_config(name, reduced=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params_dev = map_leaves(lambda _, t: t.to(dev), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    caches = {d: lm.init_caches(cfg, 2, 16, torch.float32, device=d) for d in ("cpu", dev)}
    before = dict(LAUNCHES)
    last, caches[dev] = lm.prefill(params_dev, cfg, {"tokens": toks[:, :12]}, caches[dev],
                                   device=dev)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] - before.get("flash_attention", 0) == cfg.n_layers
    assert LAUNCHES["layernorm"] - before.get("layernorm", 0) == 2 * cfg.n_layers + 1
    ref, caches["cpu"] = lm.prefill(params, cfg, {"tokens": toks[:, :12]}, caches["cpu"],
                                    device="cpu")
    torch.testing.assert_close(last.cpu(), ref, atol=2e-4, rtol=0)
    for i in range(12, 16):
        before = dict(LAUNCHES)
        last, caches[dev] = lm.decode_step(params_dev, cfg, toks[:, i:i + 1].to(dev),
                                           torch.full((2,), i), caches[dev], device=dev)
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention"] == before.get("flash_attention", 0)
        assert LAUNCHES["layernorm"] - before.get("layernorm", 0) == 2 * cfg.n_layers + 1
        ref, caches["cpu"] = lm.decode_step(params, cfg, toks[:, i:i + 1], torch.full((2,), i),
                                            caches["cpu"], device="cpu")
        torch.testing.assert_close(last.cpu(), ref, atol=2e-4, rtol=0)
    for k, t in caches[dev]["layers"].items():
        torch.testing.assert_close(t.cpu(), caches["cpu"]["layers"][k], atol=2e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,n", [(24, 128), (64, 64)])  # mamba2-130m's and zamba2's widths
def test_ssd_scan_gradients_match_plain(dev, h, n, dtype):
    """Under grad the wrapper launches the kernel inside ``SSDScan``; its
    gradients (y's and the final state's cotangents) against torch autograd
    through the plain scan on the card: 1e-5 of each gradient's scale in
    float32, one bf16 rounding in bf16."""
    g = torch.Generator(device="cpu").manual_seed(h + n)
    x = [t.to(dev, dtype).requires_grad_() for t in _ssd_inputs(g, 2, 512, h, 64, n, 1)]
    before = LAUNCHES["ssd_scan"]
    y, state = ssd_with_state(*x, chunk=64)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == before + 1
    assert "SSDScan" in type(y.grad_fn).__name__
    dy = torch.randn(y.shape, generator=g).to(dev, dtype)
    ds = torch.randn(state.shape, generator=g).to(dev)
    grads = torch.autograd.grad((y, state), x, (dy, ds))
    y_ref, s_ref = _ssd_plain(*x, 64)
    ref = torch.autograd.grad((y_ref.to(dtype), s_ref), x, (dy, ds))
    assert LAUNCHES["ssd_scan"] == before + 1  # the backward launches no kernel
    for gr, rf, t in zip(grads, ref, x):
        assert gr.dtype == t.dtype and torch.isfinite(gr.float()).all()
        scale = max(1.0, float(rf.float().abs().max()))
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(gr.float(), rf.float(), atol=tol * scale, rtol=0)


@pytest.mark.parametrize("name", ["mamba2-130m", "zamba2-1.2b"])
def test_ssm_and_hybrid_train_step_on_the_card(dev, name):
    """One train step of the reduced config from the CPU's state: the loss
    within 1e-4 of the CPU path's, ``ssd_scan`` launched once per Mamba2
    layer and ``flash_attention`` once per shared application."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.params import map_leaves
    from repro_torch.optim import AdamW
    from repro_torch.train import make_train_state, train_step

    cfg = get_config(name, reduced=True)
    opt = AdamW(schedule=lambda s: 1e-3)
    state = make_train_state(cfg, opt, torch.Generator().manual_seed(0), device="cpu")
    state_dev = map_leaves(lambda _, t: t.to(dev), state)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(1))
    before = dict(LAUNCHES)
    _, m_dev = train_step(state_dev, {"tokens": toks.to(dev)}, cfg=cfg, optimizer=opt)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] - before.get("ssd_scan", 0) == cfg.n_layers
    assert LAUNCHES["flash_attention"] - before.get("flash_attention", 0) == lm.n_shared_apps(cfg)
    _, m = train_step(state, {"tokens": toks}, cfg=cfg, optimizer=opt)
    np.testing.assert_allclose(float(m_dev["loss"]), float(m["loss"]), rtol=0, atol=1e-4)


def test_kernel_wrappers_refuse_a_dtensor(dev, tmp_path):
    """A DTensor on a one-card mesh: every wrapper raises rather than read
    one shard's pointer."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'pg'}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        t = distribute_tensor(torch.ones(1, 2, 64, 64, device=dev), mesh,
                              [Replicate(), Replicate()])
        calls = [lambda: mha(t, t, t), lambda: layernorm(t, torch.ones(64, device=dev)),
                 lambda: ssd(t, t[..., 0], t, t, chunk=64), lambda: lut_softmax(t),
                 lambda: qmatmul(t[0, 0], t[0, 0])]
        for call in calls:
            with pytest.raises(TypeError, match="DTensor"):
                call()
    finally:
        dist.destroy_process_group()


# ------------------------------------------ the serving engine's device ops --


@pytest.mark.parametrize("name", ["k", "k_scale", "latent", "latent_scale"])
def test_paged_window_write_on_the_card(dev, name):
    """The cache-extend window scatter on CUDA tensors: the rows the CPU
    writes, bitwise (the trash page, which takes the sentinel writes in no
    defined order, aside)."""
    from repro_torch.serve import kv_cache

    g = torch.Generator().manual_seed(3)
    b, w, length, ps = 3, 6, 32, 8
    pos = torch.tensor([[0, 1, 2, 3, 4, 5], [7, 8, 9, 32, 32, 32], [31, 32, 32, 32, 32, 32]])
    n_pages = b * length // ps + 1
    head = name.startswith("k")
    pool_shape = (n_pages, 4, ps, 16) if name == "k" else (
        (n_pages, 4, ps) if head else (n_pages, ps, 12) if name == "latent" else (n_pages, ps))
    upd_shape = (b, 4, w) + pool_shape[3:] if head else (b, w) + pool_shape[2:]
    pool, upd = torch.randn(pool_shape, generator=g), torch.randn(upd_shape, generator=g)
    table = torch.randperm(n_pages - 1, generator=g).add(1).int().reshape(b, length // ps)
    outs = []
    for d in ("cpu", dev):
        cache = {name: pool.clone().to(d), "page_table": table.to(d)}
        kv_cache.paged_window_write(cache, {name: upd.to(d)}, pos.to(d))
        outs.append(cache[name].cpu())
    assert torch.equal(outs[0][1:], outs[1][1:])


def test_flush_swaps_round_trips_rows_on_the_card(dev):
    """The victim tier with a card: the rings are pinned host memory, a
    spill's rows reach the ring by the time ``flush_swaps`` returns, and a
    swap-in writes them back into a fresh device page bitwise."""
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.serve.kv_cache import CacheManager

    sc = ServeConfig(max_batch=2, max_seq_len=32, kv_layout="paged", kv_page_size=4, kv_pages=4,
                     kv_prefix_cache=True, kv_host_pages=2)
    mgr = CacheManager(get_config("granite-8b", reduced=True), sc, device=dev)
    assert all(r.is_pinned() for r in mgr._host_pool.values())
    caches = mgr.init_device_caches()
    for n in ("k", "v"):
        caches["layers"][n].normal_()
    prompt = [1, 2, 0, 1]
    mgr.admit(0, prompt, 5)
    page = mgr._slot_pages[0][0]
    rows = {n: caches["layers"][n][:, page].clone() for n in ("k", "v")}
    mgr.free(0)
    mgr.admit(1, [2] * 12, 12)  # every page: the prefix page spills
    mgr.flush_swaps(caches)
    host = mgr._host_index[mgr._key_intern[(0, tuple(prompt))]]
    for n in ("k", "v"):
        assert torch.equal(mgr._host_pool[n][:, host], rows[n].cpu())
        caches["layers"][n][:, page] = 0.0
    mgr.free(1)
    match = mgr.match_prefix(prompt)
    mgr.admit(0, prompt, 5, match=match, lazy_tail=True, write_from=3)
    dst = mgr._slot_pages[0][0]
    mgr.flush_swaps(caches)
    mgr.write_table(caches)
    torch.cuda.synchronize()
    for n in ("k", "v"):
        assert torch.equal(caches["layers"][n][:, dst], rows[n])
    assert caches["layers"]["page_table"][0, 0, 0].item() == dst
    mgr.check_invariants()


def test_async_carry_merge_makes_no_synchronizing_call(dev):
    """What a pure decode dispatch adds to the decode steps under the async
    loop: the host rows and the validity mask go up through pinned buffers,
    the carry merges by ``torch.where`` on the card, and the packed results
    come down without blocking; under ``set_sync_debug_mode("error")`` none
    of it raises, and the results read after the event are right."""
    from repro_torch.device import upload

    carry = tuple(torch.arange(8, device=dev, dtype=torch.int32) + k for k in range(3))
    valid = np.array([True, False] * 4)
    host_rows = np.arange(24, dtype=np.int32).reshape(3, 8) * 10
    upload(host_rows, dev)  # warm the pinned pool and the copy path
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rows = upload(host_rows, dev)
        v = upload(valid, dev)
        merged = torch.stack([torch.where(v, c, r) for c, r in zip(carry, rows)])
        valid[:] = False  # a later host write does not reach the copy
        host = merged.to("cpu", non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    done.synchronize()
    want = np.where(np.array([True, False] * 4), np.stack([c.cpu().numpy() for c in carry]),
                    host_rows)
    np.testing.assert_array_equal(host.numpy(), want)


def test_spans_line_up_with_the_device_trace(dev):
    """A span opened around a launch and ``torch.profiler``'s record of the
    launch share one clock: each launching runtime call starts inside its
    span, each kernel (a torch operation's and a hand-written one's) is
    attributed to its span by correlation id, and the clocks agree to
    50 µs (the closest a launch came to either end of its span bounds
    their offset from both sides)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace

    x = torch.randn(4096, 1024, device=dev)
    gamma, beta = torch.ones(1024, device=dev), torch.zeros(1024, device=dev)
    x.add_(1)
    layernorm(x, gamma, beta)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trace.start()
        try:
            for _ in range(20):
                with trace.span("add"):
                    x.add_(1)
                with trace.span("norm"):
                    layernorm(x, gamma, beta)
        finally:
            spans = trace.stop()
        torch.cuda.synchronize()
    ops = [op for op in trace.device_ops(prof) if op[3]]
    by_id = {s.id: s for s in spans}
    owners = trace.innermost(spans, [op[3] for op in ops])
    kinds = {"add": "elementwise", "norm": "layernorm"}
    hits = {name: 0 for name in kinds}
    after_open, before_close = [], []
    for op, sid in zip(ops, owners):
        assert sid, f"{op[2]} launched outside every span"
        s = by_id[sid]
        assert kinds[s.name] in op[2], (s, op)
        assert s.start <= op[3] <= s.end
        hits[s.name] += 1
        after_open.append(op[3] - s.start)
        before_close.append(s.end - op[3])
    assert hits == {"add": 20, "norm": 20}
    print(f"[trace] launch after span open: min {min(after_open) / 1e3:.1f} us, median "
          f"{sorted(after_open)[20] / 1e3:.1f} us; span close after launch: min "
          f"{min(before_close) / 1e3:.1f} us, median {sorted(before_close)[20] / 1e3:.1f} us")
    assert min(after_open) < 50_000 and min(before_close) < 50_000

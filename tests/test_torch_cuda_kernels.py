"""The hand-written CUDA kernels against their plain PyTorch versions on the
card.  Marked ``cuda``; they skip where no CUDA device is present.  Run them
on a GPU machine with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flash_attention import mha, mha_ref  # noqa: E402
from repro_torch.kernels.layernorm import layernorm, layernorm_ref  # noqa: E402

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


@pytest.mark.parametrize("rows,k", [(120, 64), (800, 32), (33, 200), (64, 4096)])
@pytest.mark.parametrize("use_lut", [False, True])
@pytest.mark.parametrize("rms", [False, True])
def test_layernorm_kernel_matches_plain(dev, rows, k, use_lut, rms):
    g = torch.Generator(device="cpu").manual_seed(rows + k)
    x = (torch.randn(rows, k, generator=g) * 3).to(dev)
    gamma, beta = (torch.randn(k, generator=g).to(dev) for _ in range(2))
    before = LAUNCHES["layernorm"]
    out = layernorm(x, gamma, beta, use_lut=use_lut, rms=rms)
    torch.cuda.synchronize()
    assert LAUNCHES["layernorm"] == before + 1
    ref = layernorm_ref(x, gamma, beta, use_lut=use_lut, rms=rms)
    # 1e-5 (float order); in LUT mode a row whose variance sits at a table
    # tie may take the neighbouring 1/sqrt entry, 0.27 % away
    err = (out - ref).abs()
    assert (err <= 1e-5 + (0.003 * (ref.abs() + beta.abs()) if use_lut else 0)).all()
    assert (err > 1e-5).any(dim=-1).float().mean() <= 0.01


def test_cuda_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.randn(4, 2, 10, 12, device=dev)  # head_dim 12 has no kernel
    with pytest.raises(ValueError, match="head_dim"):
        mha(x, x, x)
    x = torch.randn(4, 2, 10, 8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        mha(x.transpose(1, 2), x.transpose(1, 2), x.transpose(1, 2))
    with pytest.raises(ValueError, match="float32"):
        layernorm(torch.randn(4, 8, device=dev, dtype=torch.float16),
                  torch.ones(8, device=dev), torch.zeros(8, device=dev))

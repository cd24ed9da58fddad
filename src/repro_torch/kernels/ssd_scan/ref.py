"""Plain PyTorch versions of the SSD chunked-scan kernel.

``ssd_chunked`` is a torch copy of the reference's ``models/ssm.ssd_chunked``
(quadratic within q-step chunks, a linear scan over the chunk states) in the
(b, l, h, ·) layout, and ``ssd_naive_ref`` its step-by-step recurrence;
``models.ssm`` re-exports both.  ``ssd_scan_ref`` / ``ssd_scan_naive`` take
the kernel's (BH, L, ·) layout, upcast to float32 as the kernel does, and
return ``y`` in the input type with the final (BH, P, N) float32 state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., q) -> (..., q, q) with [i, j] = sum_{m=j+1..i} a_m (i >= j),
    -inf above the diagonal (so its exp is 0, never inf).  The prefix sums
    are taken in float64: a difference of two large float32 sums keeps only
    ~|cs| 2^-24 of its digits (strong decay), the reference's float32 ones."""
    cs = torch.cumsum(a.double(), dim=-1)
    diff = (cs[..., :, None] - cs[..., None, :]).to(a.dtype)
    q = a.shape[-1]
    idx = torch.arange(q, device=a.device)
    return diff.masked_fill(idx[:, None] < idx[None, :], float("-inf"))


def ssd_chunked(
    xdt: torch.Tensor,  # (b, l, h, p) inputs pre-multiplied by dt
    a: torch.Tensor,  # (b, l, h) log-decay = dt * A  (A < 0)
    bmat: torch.Tensor,  # (b, l, h, n) per-head B
    cmat: torch.Tensor,  # (b, l, h, n) per-head C
    *,
    chunk: int,
    initial_state: torch.Tensor | None = None,  # (b, h, p, n)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y (b, l, h, p), final_state (b, h, p, n))."""
    b, l, h, p = xdt.shape
    n = bmat.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the chunk {chunk}")
    nc = l // chunk

    xc = xdt.reshape(b, nc, chunk, h, p)
    ac = a.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)  # (b, h, c, q)
    bc = bmat.reshape(b, nc, chunk, h, n)
    cc = cmat.reshape(b, nc, chunk, h, n)
    cs64 = torch.cumsum(ac.double(), dim=-1)  # float64, as _segsum
    a_cumsum = cs64.to(ac.dtype)

    # 1. intra-chunk (quadratic, the "attention-like" term)
    el = torch.exp(_segsum(ac))  # (b, h, c, q, q)
    scores = torch.einsum("bcqhn,bckhn->bhcqk", cc, bc)
    y_diag = torch.einsum("bhcqk,bckhp->bcqhp", scores * el, xc)

    # 2. what each chunk contributes to the running state
    decay_states = torch.exp((cs64[..., -1:] - cs64).to(ac.dtype))  # (b, h, c, q)
    states = torch.einsum("bckhn,bhck,bckhp->bchpn", bc, decay_states, xc)

    # 3. inter-chunk recurrence over the chunk states
    if initial_state is None:
        initial_state = torch.zeros((b, h, p, n), dtype=xdt.dtype, device=xdt.device)
    a_pad = F.pad(a_cumsum[..., -1], (1, 0))  # (b, h, c + 1)
    decay_chunk = torch.exp(_segsum(a_pad))  # (b, h, c + 1, c + 1)
    all_states = torch.cat([initial_state[:, None], states], dim=1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, all_states)
    states_in, final_state = new_states[:, :-1], new_states[:, -1]

    # 4. carried state -> output within each chunk
    state_decay = torch.exp(a_cumsum)  # (b, h, c, q)
    y_off = torch.einsum("bcqhn,bchpn,bhcq->bcqhp", cc, states_in, state_decay)
    return (y_diag + y_off).reshape(b, l, h, p), final_state


def ssd_naive_ref(
    xdt: torch.Tensor,  # (b, l, h, p)
    a: torch.Tensor,  # (b, l, h)
    bmat: torch.Tensor,  # (b, l, h, n)
    cmat: torch.Tensor,  # (b, l, h, n)
    initial_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step recurrence oracle: h' = exp(a) h + x B^T, y = h' C."""
    b, l, h, p = xdt.shape
    n = bmat.shape[-1]
    state = (torch.zeros((b, h, p, n), dtype=xdt.dtype, device=xdt.device)
             if initial_state is None else initial_state)
    ys = []
    for t in range(l):
        da = torch.exp(a[:, t])[..., None, None]
        state = state * da + torch.einsum("bhp,bhn->bhpn", xdt[:, t], bmat[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cmat[:, t]))
    return torch.stack(ys, dim=1), state


def _unfold(xdt, a, bmat, cmat):
    """(BH, L, ·) kernel layout -> float32 (b=BH, l, h=1, ·) model layout."""
    f = torch.float32
    return (xdt.to(f)[:, :, None, :], a.to(f)[..., 0][:, :, None],
            bmat.to(f)[:, :, None, :], cmat.to(f)[:, :, None, :])


def ssd_scan_ref(xdt, a, bmat, cmat, *, chunk: int = 64):
    """(BH, L, P), (BH, L, 1), (BH, L, N) x 2 -> (y (BH, L, P) in the input
    type, final state (BH, P, N) float32), via ``ssd_chunked``."""
    y, state = ssd_chunked(*_unfold(xdt, a, bmat, cmat), chunk=chunk)
    return y[:, :, 0, :].to(xdt.dtype), state[:, 0]


def ssd_scan_naive(xdt, a, bmat, cmat):
    """As ``ssd_scan_ref``, through the step recurrence."""
    y, state = ssd_naive_ref(*_unfold(xdt, a, bmat, cmat))
    return y[:, :, 0, :].to(xdt.dtype), state[:, 0]

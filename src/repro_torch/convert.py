"""Carry parameters across from the JAX package.

The JAX side is handed over as numpy arrays (for example
``jax.tree.map(np.asarray, params)``), so this module needs no JAX.  Dtypes
and the stacked ``blocks`` and cache layouts are kept.  A train state
``{"params", "opt": {"step", "mu", "nu"}}`` converts both ways
(``train_state_from_numpy`` / ``train_state_to_numpy``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import QTensor
from repro_torch.core.streaming_mha import StreamingMHAParams
from repro_torch.device import resolve_device


def _to_tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: exact via float32
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def params_from_numpy(tree, device: str | torch.device = "cuda"):
    """Nested dicts of numpy arrays -> the same nesting of tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return _to_tensor(tree, dev)


# the stacked per-layer cache trees that convert: the ssm (and hybrid) family's
# state, the dense KV slabs, the rolling sliding-window buffer and the paged pools, each
# of the last three also as the int8 KV cache (codes plus k/v scales), and
# MLA's latent, dense and paged, float or int8 (codes plus latent_scale)
_KV_LAYOUTS = ({"k", "v"}, {"k", "v", "slot_pos"}, {"k", "v", "page_table"})
_LATENT_LAYOUTS = ({"latent"}, {"latent", "page_table"})
_MAMBA = {"ssm_state", "conv_state"}
_CACHE_LAYOUTS = (_MAMBA, *_KV_LAYOUTS,
                  *(kv | {"k_scale", "v_scale"} for kv in _KV_LAYOUTS),
                  *_LATENT_LAYOUTS, *(lat | {"latent_scale"} for lat in _LATENT_LAYOUTS))


def train_state_from_numpy(tree, device: str | torch.device = "cuda"):
    """The JAX package's train state ``{"params", "opt": {"step", "mu",
    "nu"}}`` as numpy -> the port's (``AdamW``'s state: an int32 scalar
    step, float32 moments mirroring the parameters)."""
    if set(tree) != {"params", "opt"} or set(tree["opt"]) != {"step", "mu", "nu"}:
        raise ValueError(f"a train state is {{'params', 'opt': {{'step', 'mu', 'nu'}}}}, got "
                         f"{sorted(tree)} / {sorted(tree.get('opt', {}))}")
    state = params_from_numpy(tree, device)
    state["opt"]["step"] = state["opt"]["step"].to(torch.int32)
    return state


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy; bfloat16 (which numpy lacks) comes out as float32, exactly."""
    t = t.detach().to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def train_state_to_numpy(state):
    """The port's train state (any nesting of tensors) -> the same nesting of
    numpy arrays, for the JAX package or a comparison."""
    if isinstance(state, dict):
        return {k: train_state_to_numpy(v) for k, v in state.items()}
    return _to_numpy(state)


def caches_from_numpy(tree, device: str | torch.device = "cuda"):
    """The JAX package's stacked model caches as numpy -> the port's.

    ``{"layers": {...}}`` with a leading layer axis: the ``ssm`` family's
    ``ssm_state`` and ``conv_state`` (float32), or the dense family's ``k``
    and ``v`` slabs (B, Hkv, L, D), plus the int32 ``slot_pos`` of a rolling
    buffer, or the paged ``k`` / ``v`` pools and the int32 ``page_table``;
    each KV layout also as the int8 cache, int8 ``k`` / ``v`` codes with
    float32 ``k_scale`` / ``v_scale``; or MLA's packed ``latent`` (B, L,
    width), or its pools (num_pages, page_size, width) with the
    ``page_table``, each also as int8 codes with a float32 ``latent_scale``;
    or the hybrid family's Mamba2 ``layers`` with ``"shared"``: the shared
    block's dense ``k`` and ``v`` (n_apps, B, H, L, D)."""
    hybrid = set(tree) == {"layers", "shared"}
    if not (set(tree) == {"layers"} and set(tree["layers"]) in _CACHE_LAYOUTS
            or hybrid and set(tree["layers"]) == _MAMBA and set(tree["shared"]) == {"k", "v"}):
        raise ValueError(
            f"not a cache tree of the port: {sorted(tree)} / "
            f"{sorted(tree.get('layers', {}))} / {sorted(tree.get('shared', {}))}"
        )
    return params_from_numpy(tree, device)


def streaming_mha_params_from_numpy(tree, device: str | torch.device = "cuda"):
    """The JAX package's ``StreamingMHAParams`` as numpy -> the port's.

    ``tree`` maps ``wq``, ``wk``, ``wv``, ``wo`` to ``{"values", "scale",
    "axis"}`` (a ``QTensor``'s codes, scales and channel axis) and, where
    present, ``bq``, ``bk``, ``bv``, ``bo`` to bias arrays.  The K-major
    copies of the codes (``StreamingMHAParams.kmajor``) are made here, on
    ``device``."""
    dev = resolve_device(device)
    weights = {
        name: QTensor(_to_tensor(tree[name]["values"], dev),
                      _to_tensor(tree[name]["scale"], dev), tree[name]["axis"])
        for name in ("wq", "wk", "wv", "wo")
    }
    biases = {name: None if tree.get(name) is None else _to_tensor(tree[name], dev)
              for name in ("bq", "bk", "bv", "bo")}
    return StreamingMHAParams(**weights, **biases)

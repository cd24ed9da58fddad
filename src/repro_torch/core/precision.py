"""Declarative per-layer precision policies (port of ``repro.core.precision``).

A :class:`PrecisionPolicy` is an ordered list of ``fnmatch`` rules over
tensor-class paths (``layers.{i}.weights``, ``*.activations``,
``layers.*.attn.softmax``, ``layers.*.norm``, ``kv_cache``, ``accum``, ...);
last match wins, unmatched slots are float.  ``resolve`` turns it into a
:class:`PrecisionPlan` for one model, which the model code reads.

Presets: ``float``, ``int8_serve``, ``paper_vu13p`` and the parametric
``ptq_fixed<W,I>`` / ``qat_fixed<W,I>`` families.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import functools
import re

import torch

from repro_torch import trace
from repro_torch.core import fixed_point as fxp
from repro_torch.core import quant as quant_lib

_KINDS = ("float", "fixed", "int8", "lut")


@dataclasses.dataclass(frozen=True)
class Precision:
    """The precision of one tensor-class slot: ``float``, ``fixed``
    (ap_fixed; ``method`` ptq snaps parameters offline, qat also
    fake-quantizes at run time), ``int8`` (codes + scales) or ``lut``
    (the paper's table datapath; ``bits`` is the address width)."""

    kind: str = "float"
    total_bits: int | None = None
    int_bits: int | None = None
    method: str = "ptq"
    per_channel: bool = True
    bits: int = 8

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown precision kind {self.kind!r}")
        if self.kind == "fixed":
            if self.total_bits is None or self.int_bits is None:
                raise ValueError("fixed precision requires total_bits/int_bits")
            if self.method not in ("ptq", "qat"):
                raise ValueError(f"unknown fixed method {self.method!r}")
            fxp.ap_fixed(self.total_bits, self.int_bits)

    def fixed_cfg(self) -> fxp.FixedPointConfig | None:
        if self.kind != "fixed":
            return None
        return fxp.ap_fixed(self.total_bits, self.int_bits)

    def to_dict(self) -> dict:
        d: dict = {"kind": self.kind}
        if self.kind == "fixed":
            d.update(
                total_bits=self.total_bits, int_bits=self.int_bits, method=self.method
            )
        elif self.kind == "int8":
            d.update(per_channel=self.per_channel, bits=self.bits)
        elif self.kind == "lut":
            d.update(bits=self.bits)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Precision":
        return cls(**d)


FLOAT = Precision("float")


def fixed(total_bits: int, int_bits: int, method: str = "ptq") -> Precision:
    return Precision("fixed", total_bits=total_bits, int_bits=int_bits, method=method)


def int8(per_channel: bool = True, bits: int = 8) -> Precision:
    return Precision("int8", per_channel=per_channel, bits=bits)


def int8_perchannel() -> Precision:
    return int8(per_channel=True)


def lut8(bits: int = 8) -> Precision:
    return Precision("lut", bits=bits)


_FIXED_RE = re.compile(r"^(ptq|qat)_fixed<(\d+)\s*,\s*(\d+)>$")


def parse_precision(s: str) -> Precision:
    """Parse a precision literal: ``float``, ``int8``, ``int8_pertensor``,
    ``lut8``, ``ptq_fixed<12,6>``, ``qat_fixed<12,6>``."""
    if s == "float":
        return FLOAT
    if s in ("int8", "int8_perchannel"):
        return int8(per_channel=True)
    if s == "int8_pertensor":
        return int8(per_channel=False)
    if s == "lut8":
        return lut8()
    m = _FIXED_RE.match(s)
    if m:
        return fixed(int(m.group(2)), int(m.group(3)), method=m.group(1))
    raise ValueError(f"cannot parse precision literal {s!r}")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One pattern -> precision assignment (last matching rule wins)."""

    pattern: str
    precision: Precision

    def matches(self, path: str) -> bool:
        return fnmatch.fnmatchcase(path, self.pattern)

    def to_dict(self) -> dict:
        return {"pattern": self.pattern, "precision": self.precision.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "Rule":
        return cls(d["pattern"], Precision.from_dict(d["precision"]))


# what each slot class is allowed to resolve to
_SLOT_KINDS = {
    "weights": ("float", "fixed", "int8"),
    "activations": ("float", "fixed"),
    "softmax": ("float", "lut"),
    "norm": ("float", "fixed", "lut"),
    "kv_cache": ("float", "int8"),
    "accum": ("float", "fixed"),
}


@dataclasses.dataclass(frozen=True)
class SlotPlan:
    """Resolved (weights, activations) pair for one dense site group."""

    weights: Precision = FLOAT
    activations: Precision = FLOAT


@dataclasses.dataclass(frozen=True)
class LayerPlan(SlotPlan):
    """Per-layer resolution: dense sites + softmax + norm datapaths."""

    softmax: Precision = FLOAT
    norm: Precision = FLOAT


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Ordered pattern-based precision rules; resolve() per model."""

    name: str
    rules: tuple[Rule, ...] = ()

    def _lookup(self, path: str, slot_class: str) -> Precision:
        hit = FLOAT
        for rule in self.rules:
            if rule.matches(path):
                hit = rule.precision
        if hit.kind not in _SLOT_KINDS[slot_class]:
            raise ValueError(
                f"policy {self.name!r}: precision {hit} is not valid for "
                f"{path} (class {slot_class!r} accepts {_SLOT_KINDS[slot_class]})"
            )
        return hit

    def _slot(self, prefix: str) -> SlotPlan:
        return SlotPlan(
            weights=self._lookup(f"{prefix}.weights", "weights"),
            activations=self._lookup(f"{prefix}.activations", "activations"),
        )

    def resolve(self, model) -> "PrecisionPlan":
        """Resolve into a concrete per-layer plan (``model``: an int layer
        count or anything with ``.n_layers``)."""
        n_layers = getattr(model, "n_layers", model)
        layers = tuple(
            LayerPlan(
                weights=self._lookup(f"layers.{i}.weights", "weights"),
                activations=self._lookup(f"layers.{i}.activations", "activations"),
                softmax=self._lookup(f"layers.{i}.attn.softmax", "softmax"),
                norm=self._lookup(f"layers.{i}.norm", "norm"),
            )
            for i in range(n_layers)
        )
        return PrecisionPlan(
            policy=self,
            layers=layers,
            embed=self._slot("embed"),
            logits=self._slot("logits"),
            shared=self._slot("shared"),
            final_norm=self._lookup("norm.weights", "weights"),
            kv_cache=self._lookup("kv_cache", "kv_cache"),
            accum=self._lookup("accum", "accum"),
        )

    def to_dict(self) -> dict:
        return {"name": self.name, "rules": [r.to_dict() for r in self.rules]}

    @classmethod
    def from_dict(cls, d: dict) -> "PrecisionPolicy":
        return cls(d["name"], tuple(Rule.from_dict(r) for r in d["rules"]))


@dataclasses.dataclass(frozen=True)
class PrecisionPlan:
    """One policy resolved against one model."""

    policy: PrecisionPolicy
    layers: tuple[LayerPlan, ...]
    embed: SlotPlan
    logits: SlotPlan
    shared: SlotPlan
    final_norm: Precision
    kv_cache: Precision
    accum: Precision

    @property
    def int8_weights(self) -> bool:
        return any(
            s.weights.kind == "int8"
            for s in (*self.layers, self.embed, self.logits, self.shared)
        )

    @property
    def int8_kv_cache(self) -> bool:
        return self.kv_cache.kind == "int8"

    @property
    def lut_softmax(self) -> bool:
        return self.softmax_mode() == "lut"

    def softmax_mode(self) -> str:
        """Attention softmax mode; must be uniform across layers."""
        kinds = {lp.softmax.kind for lp in self.layers} or {"float"}
        if len(kinds) > 1:
            raise ValueError(
                f"policy {self.policy.name!r}: per-layer mixed softmax "
                "precision is not supported by the fused kernel path; use "
                "a uniform softmax rule (e.g. 'layers.*.attn.softmax')"
            )
        return "lut" if kinds == {"lut"} else "safe"

    def norm_mode(self) -> str:
        """Normalization datapath (float, lut or fixed); uniform across layers."""
        kinds = {lp.norm.kind for lp in self.layers} or {"float"}
        if len(kinds) > 1:
            raise ValueError(
                f"policy {self.policy.name!r}: per-layer mixed norm "
                "precision is not supported by the scan-over-layers path; "
                "use a uniform norm rule (e.g. 'layers.*.norm')"
            )
        return next(iter(kinds)) if kinds != {"float"} else "float"

    def kernel_defaults(self, kernel: dict | None) -> dict | None:
        """Fill policy-driven kernel knobs (explicit kernel dict wins)."""
        if self.softmax_mode() == "lut":
            kernel = dict(kernel or {})
            kernel.setdefault("softmax_mode", "lut")
        if self.norm_mode() == "lut":
            kernel = dict(kernel or {})
            kernel.setdefault("norm_lut", True)
        return kernel

    def _accum_cfg(self) -> fxp.FixedPointConfig:
        return self.accum.fixed_cfg() or fxp.ACCUM_CONFIG

    def quant_for(self, slot: SlotPlan, name: str = "layer") -> quant_lib.QuantConfig:
        """Runtime hook for one dense site group (``name``: its slot):
        QAT weight STE and activation fake-quant (PTQ and int8 are
        parameter transforms)."""
        w, a = slot.weights, slot.activations
        weight_cfg = w.fixed_cfg() if w.kind == "fixed" and w.method == "qat" else None
        act_cfg = a.fixed_cfg() if a.kind == "fixed" else None
        mode = "qat" if (weight_cfg is not None or act_cfg is not None) else "none"
        qc = quant_lib.QuantConfig(
            mode=mode, weight_cfg=weight_cfg, act_cfg=act_cfg,
            accum_cfg=self._accum_cfg(),
        )
        object.__setattr__(qc, "slot", name)  # frozen; not a field
        return qc

    def embed_quant(self) -> quant_lib.QuantConfig:
        return self.quant_for(self.embed, "embed")

    def logits_quant(self) -> quant_lib.QuantConfig:
        return self.quant_for(self.logits, "logits")

    def shared_quant(self) -> quant_lib.QuantConfig:
        """The hybrid family's shared attention block's hook."""
        return self.quant_for(self.shared, "shared")

    def quant_for_layer(self, i: int) -> quant_lib.QuantConfig:
        return self.quant_for(self.layers[i])

    def uniform_layer_quant(self) -> quant_lib.QuantConfig | None:
        """The single runtime hook shared by all layers, or None when the
        plan is layer-heterogeneous (use ``layer_quant_arrays`` then)."""
        first = (self.layers[0].weights, self.layers[0].activations)
        if all((lp.weights, lp.activations) == first for lp in self.layers):
            return self.quant_for_layer(0)
        return None

    def layer_quant_arrays(self) -> "LayerQuantArrays":
        """Stacked (n_layers,) fake-quant parameters; step 0 = passthrough."""

        def row(prec: Precision, runtime: bool):
            cfg = prec.fixed_cfg() if runtime else None
            if cfg is None:
                return 0.0, 0.0, 0.0
            return cfg.step, cfg.min_value, cfg.max_value

        w_rows = [
            row(lp.weights, lp.weights.kind == "fixed" and lp.weights.method == "qat")
            for lp in self.layers
        ]
        a_rows = [row(lp.activations, lp.activations.kind == "fixed") for lp in self.layers]

        def col(rows, j):
            return torch.tensor([r[j] for r in rows], dtype=torch.float32)

        return LayerQuantArrays(
            w_step=col(w_rows, 0), w_lo=col(w_rows, 1), w_hi=col(w_rows, 2),
            a_step=col(a_rows, 0), a_lo=col(a_rows, 1), a_hi=col(a_rows, 2),
        )

    @property
    def transforms_params(self) -> bool:
        slots = [lp.weights for lp in self.layers] + [
            self.embed.weights, self.logits.weights, self.shared.weights,
            self.final_norm,
        ]
        return any(p.kind in ("fixed", "int8") for p in slots)

    def to_dict(self) -> dict:
        return self.policy.to_dict()


@dataclasses.dataclass
class LayerQuantArrays:
    """QuantConfig-compatible fake-quant hook with tensor parameters;
    ``layer(i)`` gives the hook of layer ``i``."""

    w_step: torch.Tensor
    w_lo: torch.Tensor
    w_hi: torch.Tensor
    a_step: torch.Tensor
    a_lo: torch.Tensor
    a_hi: torch.Tensor

    def layer(self, i: int) -> "LayerQuantArrays":
        return LayerQuantArrays(*(t[i] for t in dataclasses.astuple(self)))

    def maybe_fake_quant_weight(self, w: torch.Tensor) -> torch.Tensor:
        with trace.span("precision", slot="layer", operand="weight"):
            return _fake_quant_traced(w, self.w_step, self.w_lo, self.w_hi)

    def maybe_fake_quant_act(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("precision", slot="layer", operand="act"):
            return _fake_quant_traced(x, self.a_step, self.a_lo, self.a_hi)


def _fake_quant_traced(x, step, lo, hi):
    """ap_fixed STE fake-quant with tensor step/bounds (0-step = identity)."""
    step, lo, hi = (t.to(device=x.device, dtype=x.dtype) for t in (step, lo, hi))
    on = step > 0
    safe = torch.where(on, step, torch.ones_like(step))
    q = torch.clamp(torch.round(x / safe), lo / safe, hi / safe) * safe
    clipped = torch.where(on, fxp.clip(x, lo, hi), x)
    q = torch.where(on, q, x)
    return clipped + (q - clipped).detach()


# ---------------------------------------------------------------------------
# Parameter-tree application (PTQ snap / int8 quantize-dequantize)
# ---------------------------------------------------------------------------

_PARAM_SLOT_ALIASES = {
    "embed": "embed",
    "frontend_proj": "embed",
    "input_proj": "embed",
    "pos_embed": "embed",
    "lm_head": "logits",
    "head1": "logits",
    "head2": "logits",
    "final_norm": "norm",
    "shared_attn": "shared",
}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _is_float_tensor(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _apply_precision_leaf(x, prec: Precision):
    if not _is_float_tensor(x):
        return x
    if prec.kind == "fixed":
        return fxp.quantize(x, prec.fixed_cfg())
    if prec.kind == "int8":
        if x.ndim < 2:
            return x  # biases / norm scales stay float
        axis = x.ndim - 1 if prec.per_channel else None
        return quant_lib.quantize_int8(x, axis=axis, bits=prec.bits).dequantize(x.dtype)
    return x


def _apply_precision_tree(tree, prec: Precision):
    if prec.kind not in ("fixed", "int8"):
        return tree
    return _tree_map(lambda leaf: _apply_precision_leaf(leaf, prec), tree)


def apply_plan_to_params(params: dict, plan: PrecisionPlan) -> dict:
    """Offline parameter transform: snap fixed-point weights onto their
    ap_fixed grids and quantize-dequantize int8 weights, per the plan.

    ``blocks`` is stacked (leading layer axis) and takes a per-layer plan;
    every other top-level key maps onto one global slot.

    It takes whole leaves: under a model group the transform runs before
    any cut (the serving executor applies it before it places the
    parameters, a split step's caller before it shards them), so each
    rank's shard of its output is exact.  An int8 leaf's per-channel scale
    comes from the whole leaf; quantizing a row-parallel shard instead
    would need a MAX over the group, which nothing here does."""
    if not plan.transforms_params:
        return params
    n_layers = len(plan.layers)
    w_precs = [lp.weights for lp in plan.layers]
    uniform = all(p == w_precs[0] for p in w_precs)
    out = {}
    for key, sub in params.items():
        if key == "blocks":
            if uniform and w_precs[0].kind == "float":
                out[key] = sub
            elif uniform and w_precs[0].kind == "fixed":
                out[key] = _apply_precision_tree(sub, w_precs[0])
            else:
                # per layer, so a stacked (n_layers, d) bias is still 1-D
                def _per_layer(leaf):
                    if not _is_float_tensor(leaf):
                        return leaf
                    if leaf.shape[0] != n_layers:
                        raise ValueError(f"stacked leaf {tuple(leaf.shape)} != {n_layers} layers")
                    return torch.stack(
                        [_apply_precision_leaf(leaf[i], w_precs[i]) for i in range(n_layers)]
                    )

                out[key] = _tree_map(_per_layer, sub)
        else:
            prefix = _PARAM_SLOT_ALIASES.get(key, key)
            prec = plan.policy._lookup(f"{prefix}.weights", "weights")
            out[key] = _apply_precision_tree(sub, prec)
    return out


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------


def _preset_float() -> PrecisionPolicy:
    return PrecisionPolicy("float", ())


def _preset_int8_serve() -> PrecisionPolicy:
    """int8 per-channel weights, int8 per-token KV cache, LUT softmax."""
    return PrecisionPolicy(
        "int8_serve",
        (
            Rule("*.weights", int8(per_channel=True)),
            Rule("kv_cache", int8(per_channel=False)),
            Rule("*.softmax", lut8()),
        ),
    )


def _preset_paper_vu13p() -> PrecisionPolicy:
    """The paper's VU13P configuration (Sec. VI-A): ap_fixed<12,6> weights
    and activations, LUT softmax and normalization, and the fixed
    10-integer-bit accumulator."""
    return PrecisionPolicy(
        "paper_vu13p",
        (
            Rule("*.weights", fixed(12, 6, method="ptq")),
            Rule("*.activations", fixed(12, 6)),
            Rule("layers.*.attn.softmax", lut8()),
            Rule("layers.*.norm", lut8()),
            Rule("accum", fixed(fxp.ACCUM_INT_BITS + 8, fxp.ACCUM_INT_BITS)),
        ),
    )


PRESETS = {
    "float": _preset_float,
    "int8_serve": _preset_int8_serve,
    "paper_vu13p": _preset_paper_vu13p,
}


def get_policy(name: "str | PrecisionPolicy") -> PrecisionPolicy:
    """A named preset, a parametric ``{ptq,qat}_fixed<W,I>`` family name,
    or a policy passed through unchanged."""
    if isinstance(name, PrecisionPolicy):
        return name
    if name in PRESETS:
        return PRESETS[name]()
    m = _FIXED_RE.match(name)
    if m:
        method, w, i = m.group(1), int(m.group(2)), int(m.group(3))
        rules: tuple[Rule, ...]
        if method == "ptq":
            rules = (Rule("*.weights", fixed(w, i, method="ptq")),)
        else:
            rules = (
                Rule("*.weights", fixed(w, i, method="qat")),
                Rule("*.activations", fixed(w, i)),
            )
        return PrecisionPolicy(name, rules)
    raise KeyError(
        f"unknown precision policy {name!r}; presets: {sorted(PRESETS)} "
        "or parametric 'ptq_fixed<W,I>' / 'qat_fixed<W,I>'"
    )


def policy_names() -> list[str]:
    return sorted(PRESETS)


def from_quant_config(qc: quant_lib.QuantConfig) -> PrecisionPolicy | None:
    """Lower a legacy QuantConfig onto an equivalent policy (None when the
    config selects nothing)."""
    rules = []
    if qc.mode in ("ptq", "qat") and qc.weight_cfg is not None:
        rules.append(
            Rule(
                "*.weights",
                fixed(
                    qc.weight_cfg.total_bits, qc.weight_cfg.int_bits,
                    method="qat" if qc.mode == "qat" else "ptq",
                ),
            )
        )
    if qc.mode == "qat" and qc.act_cfg is not None:
        rules.append(Rule("*.activations", fixed(qc.act_cfg.total_bits, qc.act_cfg.int_bits)))
    if qc.int8_weights:
        rules.append(Rule("*.weights", int8(per_channel=True)))
    if qc.int8_kv_cache:
        rules.append(Rule("kv_cache", int8(per_channel=False)))
    if qc.lut_softmax:
        rules.append(Rule("*.softmax", lut8()))
    if qc.accum_cfg != fxp.ACCUM_CONFIG:
        rules.append(Rule("accum", fixed(qc.accum_cfg.total_bits, qc.accum_cfg.int_bits)))
    if not rules:
        return None
    return PrecisionPolicy("legacy_quant_config", tuple(rules))


def model_policy(cfg) -> PrecisionPolicy:
    """The policy governing a model: its explicit ``cfg.precision``, else
    the legacy ``cfg.quant`` lowered, else float."""
    explicit = getattr(cfg, "precision", None)
    if explicit is not None:
        return get_policy(explicit)
    legacy = from_quant_config(cfg.quant)
    return legacy if legacy is not None else _preset_float()


@functools.lru_cache(maxsize=512)
def _resolve_cached(policy: PrecisionPolicy, n_layers: int) -> PrecisionPlan:
    return policy.resolve(n_layers)


def resolve_model_plan(cfg) -> PrecisionPlan:
    """Resolve a ModelConfig's governing policy (cached)."""
    return _resolve_cached(model_policy(cfg), cfg.n_layers)

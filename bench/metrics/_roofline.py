"""A kernel's share of its roofline over a traced stretch: the summed
bounds (bench/yardstick.py) of the calls recorded into its layer, over the
summed device time of the kernels that carry its name, in percent."""

from bench import yardstick

ATTENTION_KERNELS = ("small_attention_kernel", "tc_attention_kernel", "v_mean_kernel")
LAYERNORM_KERNELS = ("layernorm_kernel",)


def attention_bound_s(calls) -> float:
    total = 0.0
    for q, k, v, dtype, causal, mode in calls:
        total += yardstick.flash_attention(q[0], q[1], k[1], q[2], k[2], q[3], v[3], dtype,
                                           causal, mode).bound_s()
    return total


def layernorm_bound_s(calls) -> float:
    total = 0.0
    for shape, dtype, param_dtype, rms, use_lut in calls:
        rows = 1
        for n in shape[:-1]:
            rows *= n
        total += yardstick.layernorm(rows, shape[-1], dtype, param_dtype, rms, use_lut).bound_s()
    return total


def share(run, layer: str, kernels, bound) -> float | None:
    dt, calls = run.device_trace, run.calls.get(layer, [])
    if dt is None or not calls:
        return None
    device_s, count = dt.device_s(*kernels)
    if device_s <= 0 or count == 0:
        return None
    return bound(calls) / device_s * 100.0

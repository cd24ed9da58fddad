"""The window's model FLOPs over its seconds and the H100's bfloat16 peak
(989 TFLOP/s, at 700 W; bench/yardstick.py), in percent: the tokens
processed in the window (the prompts whose first token came in it, and
every decoded token after a first) through the configuration's reference
family's ``window_flops`` (2 x the weights a token multiplies through,
plus the attention's QKᵀ and P·V over the pairs they attend)."""

from bench import harness, yardstick


def read(run):
    if not run.requests or not run.window_s:
        return None
    tokens = sq_half = context = 0.0
    t0, t_end = run.window
    for q in run.requests:
        plen = q["prompt_len"]
        for i, ts in enumerate(q["ts"]):
            if not t0 <= ts <= t_end:
                continue
            if i == 0:
                tokens += plen
                sq_half += plen * plen / 2
            else:
                tokens += 1
                context += plen + i
    m = run.config["model_config"]
    flops = harness.reference(run.config).window_flops(m, tokens, sq_half, context)
    return flops / run.window_s / yardstick.PEAKS["bfloat16"] * 100.0

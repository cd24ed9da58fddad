"""VLM backbone (internvl2-1b): a thin wrapper over ``models.lm``.

The vision frontend is the JAX package's stub: the model takes precomputed
InternViT patch embeddings (``frontend_dim`` 1024), which the
``frontend_proj`` projector maps into the embedding space and puts before
the text tokens.  Decode runs on text tokens, the image prefix resident in
the KV cache from prefill.
"""

from __future__ import annotations

from repro_torch.models.lm import (  # noqa: F401
    count_params,
    decode_step,
    forward,
    init_params,
    loss_fn,
    param_spec,
    prefill,
)

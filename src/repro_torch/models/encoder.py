"""Encoder-only backbone (hubert-xlarge): a thin wrapper over ``models.lm``.

The audio frontend is the JAX package's stub: the model takes precomputed
frame embeddings (the convolutional feature extractor is out of scope),
which ``frontend_proj`` maps into d_model, and trains on HuBERT's
masked-unit prediction over ``vocab_size`` units (``labels`` from the data
pipeline).  An encoder attends both ways and has no KV cache, so no decode
step.
"""

from __future__ import annotations

from repro_torch.models.lm import (  # noqa: F401
    count_params,
    forward,
    init_params,
    loss_fn,
    param_spec,
)

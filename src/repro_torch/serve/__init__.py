"""Serving substrate of the port.  So far the cache specs and the stacked
model caches (``kv_cache``): dense KV slabs, rolling sliding-window buffers
and the ``ssm`` family's state; sampling, the paged KV cache, the scheduler
and the engine come with ROADMAP queue 1, items 5-8."""

"""Serving substrate of the port.  So far the stacked model caches of the
``ssm`` family (``kv_cache``); the engine, scheduler and paged KV cache
come with ROADMAP queue 1, items 5-8."""

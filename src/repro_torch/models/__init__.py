"""The LLM substrate's serving path: config, blocks, transformer stack and
the public model API (``init_params``, ``init_cache``,
``make_prefill_step``, ``make_serve_step``)."""

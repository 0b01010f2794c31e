"""Data pipelines of the LLM substrate: the deterministic synthetic token stream."""

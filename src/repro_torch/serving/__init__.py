"""Serving of the port's LLM substrate: the batched engine and samplers."""

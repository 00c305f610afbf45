"""The port's LLM substrate: layers, GQA attention, transformer blocks,
model assembly, and conversion of the reference's parameters."""

"""The port's models: the LLM substrate's layers, GQA attention,
transformer blocks, model assembly and conversion of the reference's
parameters, and the SpGEMM dispatch cost model (``dispatch_model``)."""

"""The port's optimizers: AdamW (``adamw``), a torch port of the
reference's, used by the dispatch model's training and by training."""

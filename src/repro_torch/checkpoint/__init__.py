"""Training checkpoints of the port (``ckpt``)."""

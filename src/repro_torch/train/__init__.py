"""Training substrate: optimizers, losses, the LM loop, checkpointing,
fault tolerance."""

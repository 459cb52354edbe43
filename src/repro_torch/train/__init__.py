"""The training substrate: optimizers, checkpoints, the fault-tolerant
trainer and gradient compression, over trees of tensors."""

"""Training substrate of the LM scaffold (the port of ``repro.train``):
optimizer, step builders, checkpointing, fault tolerance, gradient
compression."""
from repro_torch.train import (  # noqa: F401
    checkpoint,
    compression,
    fault_tolerance,
    optimizer,
    train_step,
)

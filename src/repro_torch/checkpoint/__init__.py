"""Fault-tolerant checkpointing of train states, the port of the JAX
package's ``checkpoint/``."""
from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]

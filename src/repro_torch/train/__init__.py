"""The training step and loop of the dense LM stack, the port of the JAX
package's ``train/``."""
from repro_torch.train.loop import train
from repro_torch.train.state import (
    TrainState, make_train_state_defs, make_train_step)

__all__ = ["TrainState", "make_train_state_defs", "make_train_step", "train"]

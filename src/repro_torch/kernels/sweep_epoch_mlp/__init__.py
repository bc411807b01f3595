"""The MLP objective's sweep kernel: one launch per (group × epoch) for every
inner update of every row, the per-sample forward and backward inside the
update chain; its snapshot gradient and loss from the same source."""
from repro_torch.kernels.sweep_epoch_mlp.ops import (mlp_full_grad, mlp_loss,
                                                     sample_grad,
                                                     sweep_epoch_mlp)

__all__ = ["sweep_epoch_mlp", "mlp_full_grad", "mlp_loss", "sample_grad"]

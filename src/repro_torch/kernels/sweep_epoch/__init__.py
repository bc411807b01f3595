"""The sweep-epoch kernel: one launch per (group × epoch) for every inner
update of every row."""
from repro_torch.kernels.sweep_epoch.ops import sweep_epoch

__all__ = ["sweep_epoch"]

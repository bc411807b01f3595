from repro_torch.kernels.svrg_update import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]

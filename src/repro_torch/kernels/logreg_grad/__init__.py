from repro_torch.kernels.logreg_grad import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]

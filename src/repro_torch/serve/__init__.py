"""Batched serving loop of the port: prefill, then greedy or temperature decode."""
from repro_torch.serve.loop import ServeSession, generate

__all__ = ["ServeSession", "generate"]

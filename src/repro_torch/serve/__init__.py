"""Batched serving loop of the port: prefill, then greedy or temperature decode."""

"""Dense decoder-only transformer of the port: layers, the model, its factory."""

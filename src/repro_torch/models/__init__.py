"""Models of the port: the dense decoder-only transformer, the
mixture-of-experts family, their layers and their factory."""

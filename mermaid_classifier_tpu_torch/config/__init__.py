"""Settings and option dataclasses of the PyTorch port (stdlib only)."""

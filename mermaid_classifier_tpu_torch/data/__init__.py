"""Data containers of the PyTorch port: per-image feature files, point
labels and their train/ref/val split, and training results. Copies of the
JAX package's modules of the same names; numpy only."""

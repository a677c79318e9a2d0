"""PyTorch + CUDA port of ``mermaid_classifier_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; every module here mirrors
the file layout and public names of its JAX counterpart, so a reader finds
each pair by path. This package imports ``torch`` and never ``jax``.

Slices carried so far: the point-classification serve path — image + points
-> patch crop (CUDA kernel) -> BN-folded EfficientNet trunk (fused-MBConv
CUDA kernel for the stride-1 blocks) -> calibrated MLP head -> top-N labels;
the trunk A/B harness; and the head-training lane up to the trainer
(``data/``, ``train/``, ``inference/export.py``). Kernels live in ``csrc/``
and are compiled for ``sm_90a`` with ``nvcc`` at first use (``_build.py``).
"""

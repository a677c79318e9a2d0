"""Plain PyTorch references the benchmark holds the program's output to.
They import nothing of the program."""

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """Full f32 matmuls and convs on the card."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved

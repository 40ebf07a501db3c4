"""The reference's own precision on the card: float32 products, whatever
the process set before it (the program sets its own)."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def products(tf32: bool = False):
    """Matrix products and convolutions in float32 (TF32 off), or with
    ``tf32`` in TF32 (the control's precision); the flags as they were
    afterwards."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags

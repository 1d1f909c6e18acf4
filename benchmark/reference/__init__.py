"""The plain reference of the benchmark: PyTorch and NumPy only.

It imports nothing of the program under test, nor JAX, and takes nothing
the program made: it is handed the host inputs the benchmark generated.
`precision` fixes the matmul precision it runs in: float32 (the
configurations' stated precision) or TF32, the control.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Run the block with TF32 matmuls and convolutions on or off, then
    restore the settings found."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])

"""The plain references of the benchmark: float32 PyTorch with TF32 off,
written from the configuration files alone.  They import nothing of the
program and take nothing it made: the weights are the benchmark's own
(``harness/weights.py``), and every derived quantity (rotary angles,
routing, caches) is worked out again here."""

import torch


def strict_f32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

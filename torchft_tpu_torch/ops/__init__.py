"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``), each
beside its plain PyTorch version: the wire-compression kernels of the
gradient sync (q8 error-feedback quantize, q8 decode, bf16 cast) and the
flash-attention forward and backward of the transformer's ``use_flash``
path. :data:`launch_counts` counts every kernel's launches by name.
"""

from ._lib import launch_counts, reset_launch_counts
from .flash_attention import flash_attention
from .quantize_kernels import (
    cast_bf16,
    dequantize_q8,
    quantize_q8,
    quantize_q8_ef,
)

__all__ = [
    "cast_bf16",
    "dequantize_q8",
    "flash_attention",
    "launch_counts",
    "quantize_q8",
    "quantize_q8_ef",
    "reset_launch_counts",
]

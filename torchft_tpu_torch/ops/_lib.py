"""The compiled kernel library shared by the port's ops, and the launch
counts of its kernels.

``csrc/*.cu`` build into one shared library with a plain C interface
(:func:`torchft_tpu_torch._build.build_kernels`), loaded here with ctypes
on the first CUDA launch — never at import: the CPU tests import every
module on hosts with no ``nvcc``. Every entry point launches on the
caller's stream, never synchronises and returns ``cudaGetLastError()``;
:meth:`_Kernels.launch` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

# Kernel name -> launches since the last reset (plain ints; bumped only
# where a wrapper launches its CUDA kernel, never by a plain version).
launch_counts: Dict[str, int] = {
    "q8_absmax": 0,     # K1a, replaces _absmax (quantize_kernels.py:109)
    "q8_quantize": 0,   # K1b, replaces _quantize_tiles (:175)
    "q8_dequantize": 0,  # K2, replaces dequantize_q8 (:253)
    "cast_bf16": 0,     # K3,  replaces cast_bf16 (:281)
    "flash_fwd": 0,     # K4,  replaces _flash_fwd_call (flash_attention.py:261)
    "flash_bwd": 0,     # K5,  replaces _flash_bwd_call (:382); 2 per backward
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


_VP, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_int64)
# the flash entry points' shared tail: dtype, B, S, H, D, strides,
# causal, window, block_k, fast, stream
_FLASH_TAIL = [_INT, _INT, _INT, _INT, _INT, _STRIDES, _INT, _INT, _INT,
               _INT, _VP]
_SIGNATURES = {
    "tft_q8_absmax": [_VP, _VP, _I64, _VP, _VP],
    "tft_q8_quantize": [_VP, _VP, _VP, _I64, _VP, _VP, _VP, _VP],
    "tft_q8_dequantize": [_VP, _VP, _I64, _VP, _VP],
    "tft_cast_bf16": [_VP, _I64, _VP, _VP],
    "tft_flash_fwd": [_VP] * 5 + _FLASH_TAIL,
    "tft_flash_bwd_dkdv": [_VP] * 8 + _FLASH_TAIL,
    "tft_flash_bwd_dq": [_VP] * 7 + _FLASH_TAIL,
    # kind (0 forward, 1 dk/dv, 2 dq), dtype, D, block_k
    "tft_flash_smem_bytes": [_INT] * 4,
}


class _Kernels:
    """The compiled library, loaded on first CUDA use."""

    def __init__(self) -> None:
        self._lib: Optional[ctypes.CDLL] = None

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            from .._build import build_kernels

            lib = ctypes.CDLL(build_kernels())
            for fn_name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.tft_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tft_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, name: str, fn_name: str, *args) -> None:
        lib = self.lib()
        rc = getattr(lib, fn_name)(*args)
        if rc != 0:
            raise RuntimeError(
                f"{fn_name} launch failed: "
                f"{lib.tft_cuda_error_string(rc).decode()} ({rc})"
            )
        launch_counts[name] += 1


_kernels = _Kernels()


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def device_kind(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel for tensors on {t.device}")

"""Wire-compression kernels: q8 error-feedback quantize, q8 decode and
bf16 cast.

The port of ``torchft_tpu/ops/quantize_kernels.py``. Each function here
has two bodies:

- a hand-written CUDA kernel (``csrc/quantize_kernels.cu``, built for
  ``sm_90a`` at first use) that runs for tensors on the card, and
- a plain PyTorch version of the same arithmetic that runs for tensors on
  the CPU (and that tests and ``chip_smoke.py`` hold the kernel against).

A wrapper picks the body by the tensor's device alone. On a CUDA tensor
it launches the kernel or raises; it never falls back to the plain
version. Every launch adds one to :data:`launch_counts` under the
kernel's name, so a run can show that the main path went through the
kernels.

Numerics contract (bit identity with the JAX kernels and the native
``plan_pack_ef``): ``d = x + res``; ``scale = max(max|d| / 127, 1e-12)``
with a true IEEE divide; ``q = clip(round_half_even(d / scale), ±127)``;
``res' = d - round32(q * scale)`` with two roundings. A non-finite leaf
gives codes 0, scale ``0x7FC00000`` and an all-``0x7FC00000`` residual.
``dequantize_q8`` is ``round32(float(q) * scale)`` with every NaN written
as ``0x7FC00000``, so a poisoned leaf (NaN scale) decodes to the same
bits on the card as on the host. ``cast_bf16`` rounds to nearest even
and maps every NaN to ``sign | 0x7FC0``.

Bound on the card (H100 SXM, 3.35 TB/s): bytes. The q8 pair moves at
least 13 B/element (read x and res, write the int8 code and the new
residual), the decode 5 B/element, the cast 6 B/element.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ._lib import _kernels, device_kind
from ._lib import launch_counts, reset_launch_counts  # noqa: F401 (re-exported)
from ._lib import stream as _stream

_SCALE_FLOOR = 1e-12
_CANON_NAN_BITS = 0x7FC00000


def _check_pair(x: torch.Tensor, res: torch.Tensor) -> None:
    if x.shape != res.shape:
        raise ValueError(f"x {tuple(x.shape)} and res {tuple(res.shape)} differ")
    if res.dtype != torch.float32:
        raise TypeError(f"residual must be float32, got {res.dtype}")
    if x.device != res.device:
        raise ValueError(f"x on {x.device}, res on {res.device}")


# -- K1: q8 error-feedback quantize (K1a absmax, K1b quantize) ---------------


def _q8_absmax_plain(x: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """max |x + res| as a 0-d f32 tensor; NaN if any element is NaN."""
    return (x.float() + res).abs().max()  # max propagates NaN


def _q8_quantize_plain(
    x: torch.Tensor, res: torch.Tensor, absmax: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The quantize pass in plain PyTorch ops. Division is by a tensor on
    the same device (a CPU scalar divisor can be turned into a reciprocal
    multiply), and every product and difference is its own op, so nothing
    contracts into an FMA."""
    d = x.float() + res
    scale = absmax / torch.full((), 127.0, device=d.device)
    scale = torch.where(
        scale < _SCALE_FLOOR, torch.full((), _SCALE_FLOOR, device=d.device),
        scale,
    )
    if not bool(torch.isfinite(scale)):
        nan = torch.full((), _CANON_NAN_BITS, dtype=torch.int32,
                         device=d.device).view(torch.float32)
        return (torch.zeros(d.shape, dtype=torch.int8, device=d.device),
                nan.clone(), nan.expand(d.shape).clone())
    v = torch.clamp(torch.round(d / scale), -127.0, 127.0)
    return v.to(torch.int8), scale, d - v * scale


def q8_absmax(x: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """K1a: max |x + res| over the leaf, a 0-d f32 tensor. NaN and Inf
    propagate (the kernel keeps the largest NaN payload; which NaN is not
    part of the contract — the quantize pass canonicalizes it)."""
    _check_pair(x, res)
    if device_kind(x) == "cpu":
        return _q8_absmax_plain(x, res)
    xf, rc = x.float().contiguous(), res.contiguous()
    out = torch.empty((), dtype=torch.float32, device=x.device)
    _kernels.launch("q8_absmax", "tft_q8_absmax", xf.data_ptr(),
                    rc.data_ptr(), xf.numel(), out.data_ptr(), _stream(xf))
    return out


def q8_quantize(
    x: torch.Tensor, res: torch.Tensor, absmax: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1b: ``(q int8, scale f32 0-d, new_res f32)`` of the leaf given its
    ``absmax`` (from :func:`q8_absmax`)."""
    _check_pair(x, res)
    if device_kind(x) == "cpu":
        return _q8_quantize_plain(x, res, absmax)
    if absmax.device != x.device or absmax.dtype != torch.float32 \
            or absmax.numel() != 1:
        raise ValueError("absmax must be one f32 element on the leaf's device")
    xf, rc = x.float().contiguous(), res.contiguous()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    new_res = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    _kernels.launch("q8_quantize", "tft_q8_quantize", xf.data_ptr(),
                    rc.data_ptr(), absmax.data_ptr(), xf.numel(),
                    q.data_ptr(), new_res.data_ptr(), scale.data_ptr(),
                    _stream(xf))
    return q, scale, new_res


def quantize_q8_ef(
    x: torch.Tensor, res: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Symmetric per-leaf int8 quantization with error feedback.

    ``x``: any float leaf (upcast to f32); ``res``: the f32 carry, same
    shape and device. Returns ``(q int8, scale f32 0-d, new_res f32)``,
    ``q`` and ``new_res`` shaped like ``x``. The caller owns the carry.
    On the card this is two launches: K1a (absmax), then K1b (quantize)."""
    _check_pair(x, res)
    if x.numel() == 0:
        return (torch.zeros(x.shape, dtype=torch.int8, device=x.device),
                torch.full((), _SCALE_FLOOR, device=x.device),
                torch.zeros(x.shape, dtype=torch.float32, device=x.device))
    return q8_quantize(x, res, q8_absmax(x, res))


def quantize_q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """EF-free quantization: ``(q, scale)`` of :func:`quantize_q8_ef`
    with a zero residual."""
    q, scale, _ = quantize_q8_ef(
        x, torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    )
    return q, scale


# -- K2: q8 decode ------------------------------------------------------------


def _dequantize_q8_plain(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    out = q.float() * scale.float().reshape(())
    nan = torch.full((), _CANON_NAN_BITS, dtype=torch.int32,
                     device=out.device).view(torch.float32)
    return torch.where(torch.isnan(out), nan, out)


def dequantize_q8(q: torch.Tensor, scale) -> torch.Tensor:
    """K2: the exact decode ``q * scale`` in f32 of an int8 leaf and its
    0-d f32 scale (a float is taken as one); a NaN scale poisons the
    whole leaf with ``0x7FC00000``. One launch on the card."""
    if q.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {q.dtype}")
    scale = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    if scale.numel() != 1:
        raise ValueError(f"scale must be one element, got {tuple(scale.shape)}")
    if q.numel() == 0:
        return torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    if device_kind(q) == "cpu":
        return _dequantize_q8_plain(q, scale)
    qc, sc = q.contiguous(), scale.contiguous()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _kernels.launch("q8_dequantize", "tft_q8_dequantize", qc.data_ptr(),
                    sc.data_ptr(), qc.numel(), out.data_ptr(), _stream(qc))
    return out


# -- K3: f32 -> bf16 cast -----------------------------------------------------


def _cast_bf16_plain(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest even on the integer bits, NaN -> sign | 0x7FC0.
    Not ``x.to(torch.bfloat16)``: on the CPU that maps every NaN to
    0xFFFF."""
    b = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rounded = (b + 0x7FFF + ((b >> 16) & 1)) >> 16
    nan = ((b >> 16) & 0x8000) | 0x7FC0
    r = torch.where((b & 0x7FFFFFFF) > 0x7F800000, nan, rounded)
    r = torch.where(r >= 0x8000, r - 0x10000, r)  # to signed 16-bit
    return r.to(torch.int16).view(torch.bfloat16)


def cast_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16, round to nearest even, canonical NaN; the bf16 wire's
    pack cast. One launch on the card."""
    if x.numel() == 0:
        return torch.zeros(x.shape, dtype=torch.bfloat16, device=x.device)
    if device_kind(x) == "cpu":
        return _cast_bf16_plain(x)
    xc = x.float().contiguous()
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    _kernels.launch("cast_bf16", "tft_cast_bf16", xc.data_ptr(), xc.numel(),
                    out.data_ptr(), _stream(xc))
    return out


# Plain versions by kernel name (the names of launch_counts), for holding
# a kernel against its plain version on the same (CUDA) inputs.
plain = {
    "q8_absmax": _q8_absmax_plain,
    "q8_quantize": _q8_quantize_plain,
    "q8_dequantize": _dequantize_q8_plain,
    "cast_bf16": _cast_bf16_plain,
}

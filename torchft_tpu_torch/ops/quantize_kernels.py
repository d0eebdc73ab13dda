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

Every kernel is segmented: one launch takes a table of the leaves of a
plan group (up to the kernels' capacity, 64 leaves), reading them in
place. :func:`quantize_q8_ef_group` runs one K1a and one K1b launch, the
codes written into the group's concatenated int8 buffer and the flat EF
carry advanced in place (the q8ef device pack's path,
``collectives._DeviceWirePacker``); :func:`cast_bf16_group` one K3
launch, the bf16 words written into the group's wire buffer (the bf16
device pack's path); :func:`dequantize_q8_group` one K2 launch, the
inverse of the q8ef group layout; :func:`quantize_q8_group` the EF-free
encode of the serving wire, on the K1a/K1b pair over a zero carry. The
per-leaf functions launch the same kernels with a one-segment table.

Bound on the card (H100 SXM, 3.35 TB/s): bytes. K1a reads x and res (8
B/element), K1b reads them again and writes the int8 code and the new
residual (13 B/element); the decode moves 5 B/element, the cast 6.
"""

from __future__ import annotations

import array
from typing import List, Optional, Sequence, Tuple

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
#
# On the card both passes are segmented: one launch covers every leaf of a
# table of segments (per leaf: x, carry in, carry out, element count,
# offset in the code buffer), up to the kernels' capacity per launch. The
# per-leaf wrappers launch them with a one-segment table; the group
# wrappers with one segment per leaf of a plan group, writing the codes
# into the group's concatenated buffer and the carry in place.


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


def _f32(x: torch.Tensor) -> torch.Tensor:
    """The leaf as the kernels read it: itself when f32 and contiguous,
    else an f32 copy (the only copy the q8 pair makes)."""
    if x.dtype == torch.float32 and x.is_contiguous():
        return x
    return x.float().contiguous()


def _seg_table(xs: Sequence[torch.Tensor], res_ptrs: Sequence[int],
               res_out_ptrs: Sequence[int], code_offs: Sequence[int]) -> array.array:
    """The q8 pair's segment table as the entry points read it: five int64
    per segment (x, res, res_out, n, code_off)."""
    rows: List[int] = []
    for x, r, o, off in zip(xs, res_ptrs, res_out_ptrs, code_offs):
        rows += (x.data_ptr(), r, o, x.numel(), off)
    return array.array("q", rows)


def _launch_seg(name: str, fn_name: str, table: array.array, width: int,
                tail) -> None:
    """Launches ``fn_name`` over the segments of ``table`` (rows of
    ``width`` int64) in pieces of the kernels' capacity, one launch each;
    ``tail(b)`` gives the entry point's arguments after the table for the
    piece whose first segment is ``b``."""
    cap = _kernels.lib().tft_seg_capacity()
    addr, count = table.buffer_info()[0], len(table) // width
    for b in range(0, count, cap):
        _kernels.launch(name, fn_name, addr + 8 * width * b,
                        min(cap, count - b), *tail(b))


def _absmax_launch(table: array.array, out: torch.Tensor) -> None:
    """K1a: max |x + res| of segment i into ``out[i]`` (f32)."""
    st, ptr = _stream(out), out.data_ptr()
    _launch_seg("q8_absmax", "tft_q8_absmax_seg", table, 5,
                lambda b: (ptr + 4 * b, st))


def _quantize_launch(table: array.array, absmax: torch.Tensor,
                     codes: torch.Tensor, scales: torch.Tensor) -> None:
    """K1b: segment i's codes into ``codes`` from its code offset on, its
    scale into ``scales[i]``, its new carry at its res_out."""
    st, a, q, sc = (_stream(codes), absmax.data_ptr(), codes.data_ptr(),
                    scales.data_ptr())
    _launch_seg("q8_quantize", "tft_q8_quantize_seg", table, 5,
                lambda b: (a + 4 * b, q, sc + 4 * b, st))


def q8_absmax(x: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """K1a: max |x + res| over the leaf, a 0-d f32 tensor. NaN and Inf
    propagate (the kernel keeps the largest NaN payload; which NaN is not
    part of the contract — the quantize pass canonicalizes it)."""
    _check_pair(x, res)
    if device_kind(x) == "cpu":
        return _q8_absmax_plain(x, res)
    xf, rc = _f32(x), res.contiguous()
    out = torch.empty(1, dtype=torch.float32, device=x.device)
    _absmax_launch(_seg_table([xf], [rc.data_ptr()], [0], [0]), out)
    return out.reshape(())


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
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    new_res = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    scale = torch.empty(1, dtype=torch.float32, device=x.device)
    xf, rc = _f32(x), res.contiguous()
    _quantize_launch(_seg_table([xf], [rc.data_ptr()], [new_res.data_ptr()], [0]),
                     absmax.contiguous(), q, scale)
    return q, scale.reshape(()), new_res


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


# -- K1 over a plan group -----------------------------------------------------


def _check_flat(t: torch.Tensor, name: str, dtype: torch.dtype, count: int,
                dev: torch.device) -> None:
    """``t`` is one of a group's flat buffers: contiguous 1-D ``dtype``,
    ``count`` elements, on the group's device."""
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise TypeError(f"{name} must be a contiguous 1-D {dtype} tensor, "
                        f"got {t.dtype} {tuple(t.shape)}")
    if t.numel() != count:
        raise ValueError(f"{name} holds {t.numel()} elements, the group "
                         f"needs {count}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, the group on {dev}")


def _check_leaves(leaves: Sequence[torch.Tensor], dev: torch.device) -> None:
    for l in leaves:
        if l.device != dev:
            raise ValueError(f"a leaf on {l.device}, the group on {dev}")
        if not l.is_floating_point():
            raise TypeError(f"leaves must be floating point, got {l.dtype}")


def _check_group(leaves: Sequence[torch.Tensor], res_flat: torch.Tensor,
                 codes_out: Optional[torch.Tensor] = None,
                 scales_out: Optional[torch.Tensor] = None) -> None:
    n, dev = sum(l.numel() for l in leaves), res_flat.device
    _check_flat(res_flat, "res_flat", torch.float32, n, dev)
    if codes_out is not None:
        _check_flat(codes_out, "codes_out", torch.int8, n, dev)
    if scales_out is not None:
        _check_flat(scales_out, "scales_out", torch.float32, len(leaves), dev)
    _check_leaves(leaves, dev)


def _offsets(counts: Sequence[int]) -> List[int]:
    """Each leaf's offset in the group's concatenation."""
    offs, off = [], 0
    for n in counts:
        offs.append(off)
        off += n
    return offs


def _code_offsets(leaves: Sequence[torch.Tensor]) -> List[int]:
    return _offsets([l.numel() for l in leaves])


def _group_table(xs: Sequence[torch.Tensor], res_flat: torch.Tensor,
                 res_out: Optional[torch.Tensor] = None) -> array.array:
    """One segment per leaf, its carry read from its slice of
    ``res_flat`` and written to its slice of ``res_out`` (in place when
    None), its codes at the same offset."""
    offs = _code_offsets(xs)
    res = [res_flat.data_ptr() + 4 * off for off in offs]
    out = res if res_out is None else [res_out.data_ptr() + 4 * off
                                       for off in offs]
    return _seg_table(xs, res, out, offs)


def _q8_absmax_group_plain(leaves: Sequence[torch.Tensor],
                           res_flat: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        _q8_absmax_plain(l.reshape(-1), res_flat[off:off + l.numel()])
        if l.numel() else torch.zeros((), device=res_flat.device)
        for l, off in zip(leaves, _code_offsets(leaves))
    ]) if leaves else torch.zeros(0, device=res_flat.device)


def _q8_quantize_group_plain(leaves: Sequence[torch.Tensor],
                             res_flat: torch.Tensor, absmax: torch.Tensor,
                             codes_out: torch.Tensor,
                             scales_out: torch.Tensor,
                             res_out: Optional[torch.Tensor] = None) -> None:
    """The per-leaf plain quantize pass, concatenated: codes into
    ``codes_out``, scales into ``scales_out``, the new carry into
    ``res_out`` (in place when None)."""
    dst = res_flat if res_out is None else res_out
    for k, (l, off) in enumerate(zip(leaves, _code_offsets(leaves))):
        n = l.numel()
        q, s, new = _q8_quantize_plain(l.reshape(-1), res_flat[off:off + n],
                                       absmax[k])
        codes_out[off:off + n] = q
        scales_out[k] = s
        dst[off:off + n] = new


def _quantize_q8_ef_group_plain(leaves: Sequence[torch.Tensor],
                                res_flat: torch.Tensor, codes_out: torch.Tensor,
                                scales_out: torch.Tensor,
                                res_out: Optional[torch.Tensor] = None) -> None:
    _q8_quantize_group_plain(leaves, res_flat,
                             _q8_absmax_group_plain(leaves, res_flat),
                             codes_out, scales_out, res_out)


def q8_absmax_group(leaves: Sequence[torch.Tensor],
                    res_flat: torch.Tensor) -> torch.Tensor:
    """K1a over a plan group: ``(len(leaves),)`` f32, max |x + res| per
    leaf (0 for an empty leaf), where leaf k's carry is its slice of the
    flat f32 ``res_flat``. One launch on the card (per 64 leaves)."""
    _check_group(leaves, res_flat)
    if device_kind(res_flat) == "cpu":
        return _q8_absmax_group_plain(leaves, res_flat)
    out = torch.empty(len(leaves), dtype=torch.float32, device=res_flat.device)
    if leaves:
        xs = [_f32(l) for l in leaves]
        _absmax_launch(_group_table(xs, res_flat), out)
    return out


def q8_quantize_group(leaves: Sequence[torch.Tensor], res_flat: torch.Tensor,
                      absmax: torch.Tensor, codes_out: torch.Tensor,
                      scales_out: torch.Tensor) -> None:
    """K1b over a plan group given :func:`q8_absmax_group`'s ``absmax``:
    leaf k's codes into ``codes_out`` at its offset in the group's
    concatenation, its scale into ``scales_out[k]``, and its new carry
    over its slice of ``res_flat`` (in place). One launch on the card
    (per 64 leaves)."""
    _check_group(leaves, res_flat, codes_out, scales_out)
    if absmax.dtype != torch.float32 or absmax.shape != (len(leaves),) \
            or absmax.device != res_flat.device or not absmax.is_contiguous():
        raise ValueError("absmax must be one f32 element per leaf, on the "
                         "group's device")
    if device_kind(res_flat) == "cpu":
        _q8_quantize_group_plain(leaves, res_flat, absmax, codes_out, scales_out)
    elif leaves:
        xs = [_f32(l) for l in leaves]
        _quantize_launch(_group_table(xs, res_flat), absmax, codes_out, scales_out)


def quantize_q8_ef_group(leaves: Sequence[torch.Tensor], res_flat: torch.Tensor,
                         codes_out: torch.Tensor, scales_out: torch.Tensor,
                         res_out: Optional[torch.Tensor] = None) -> None:
    """:func:`quantize_q8_ef` over every leaf of a plan group at once, into
    the group's wire buffers: ``codes_out`` (int8, the leaves' element
    count) gets the codes concatenated in leaf order, ``scales_out`` (f32,
    one per leaf) the scales, and ``res_flat`` (f32, the concatenated EF
    carry) advances in place, or, given ``res_out`` (a second flat carry
    of the same size, not overlapping it), is read and left as it was
    while the new carry lands in ``res_out``. Bit-identical to the
    per-leaf function leaf by leaf. On the card: one K1a and one K1b
    launch (per 64 leaves) over one segment table; non-f32 or
    non-contiguous leaves are copied to f32 first."""
    _check_group(leaves, res_flat, codes_out, scales_out)
    if res_out is not None:
        _check_flat(res_out, "res_out", torch.float32, res_flat.numel(),
                    res_flat.device)
    if device_kind(res_flat) == "cpu":
        _quantize_q8_ef_group_plain(leaves, res_flat, codes_out, scales_out,
                                    res_out)
        return
    if not leaves:
        return
    xs = [_f32(l) for l in leaves]
    table = _group_table(xs, res_flat, res_out)
    absmax = torch.empty(len(xs), dtype=torch.float32, device=res_flat.device)
    _absmax_launch(table, absmax)
    _quantize_launch(table, absmax, codes_out, scales_out)


def quantize_q8_group(leaves: Sequence[torch.Tensor], codes_out: torch.Tensor,
                      scales_out: torch.Tensor, zeros: torch.Tensor,
                      res_scratch: torch.Tensor) -> None:
    """:func:`quantize_q8` over every leaf of a group at once, with no
    error feedback (the serving wire): leaf k's codes into ``codes_out``
    at its offset in the leaves' concatenation, its scale into
    ``scales_out[k]``. The launches are :func:`quantize_q8_ef_group`'s
    (one K1a, one K1b per 64 leaves) over a zero carry: ``zeros`` (flat
    f32, the leaves' element count, all zero) is read and never written,
    and the residual the pair writes lands in ``res_scratch`` (the same
    size, not overlapping it). The caller owns both and keeps them
    across calls. ``d = x + 0`` turns only a ``-0.0`` into ``+0.0``,
    whose code is 0 either way, so the codes and scales are the JAX
    package's ``quantize_q8`` and its numpy oracle's for finite leaves; a
    leaf holding NaN or Inf gives codes 0 and scale ``0x7FC00000``."""
    quantize_q8_ef_group(leaves, zeros, codes_out, scales_out,
                         res_out=res_scratch)


def _quantize_q8_group_plain(leaves: Sequence[torch.Tensor],
                             codes_out: torch.Tensor,
                             scales_out: torch.Tensor) -> None:
    n = sum(l.numel() for l in leaves)
    zeros = torch.zeros(n, dtype=torch.float32, device=codes_out.device)
    _quantize_q8_ef_group_plain(leaves, zeros, codes_out, scales_out,
                                torch.empty_like(zeros))


def quantize_q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """EF-free quantization: ``(q, scale)`` of :func:`quantize_q8_ef`
    with a zero residual."""
    q, scale, _ = quantize_q8_ef(
        x, torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    )
    return q, scale


# -- K2: q8 decode ------------------------------------------------------------
#
# One launch decodes a table of segments (per leaf: destination, element
# count, offset in the group's code buffer; the scale is the segment's
# index in the scales). The layout is the inverse of quantize_q8_ef_group's.


def _dequantize_q8_plain(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    out = q.float() * scale.float().reshape(())
    nan = torch.full((), _CANON_NAN_BITS, dtype=torch.int32,
                     device=out.device).view(torch.float32)
    return torch.where(torch.isnan(out), nan, out)


def _dequantize_q8_group_plain(codes: torch.Tensor, scales: torch.Tensor,
                               counts: Sequence[int], out: torch.Tensor) -> None:
    for k, (n, off) in enumerate(zip(counts, _offsets(counts))):
        out[off:off + n] = _dequantize_q8_plain(codes[off:off + n], scales[k])


def dequantize_q8_group(codes: torch.Tensor, scales: torch.Tensor,
                        counts: Sequence[int], out: torch.Tensor) -> None:
    """:func:`dequantize_q8` over every leaf of a plan group at once: the
    int8 ``codes`` and f32 ``scales`` that :func:`quantize_q8_ef_group`
    wrote for leaves of ``counts`` elements decode into the flat f32
    ``out`` (leaf k's values at its offset in the concatenation). Bit-
    identical to the per-leaf function leaf by leaf. One launch on the
    card (per 64 leaves)."""
    counts = [int(n) for n in counts]
    if any(n < 0 for n in counts):
        raise ValueError(f"negative element count in {counts}")
    n = sum(counts)
    dev = out.device
    _check_flat(codes, "codes", torch.int8, n, dev)
    _check_flat(scales, "scales", torch.float32, len(counts), dev)
    _check_flat(out, "out", torch.float32, n, dev)
    if device_kind(out) == "cpu":
        _dequantize_q8_group_plain(codes, scales, counts, out)
        return
    if not counts:
        return
    base = out.data_ptr()
    rows: List[int] = []
    for c, off in zip(counts, _offsets(counts)):
        rows += (base + 4 * off, c, off)
    st, q, sc = _stream(out), codes.data_ptr(), scales.data_ptr()
    _launch_seg("q8_dequantize", "tft_q8_dequantize_seg", array.array("q", rows),
                3, lambda b: (q, sc + 4 * b, st))


def dequantize_q8(q: torch.Tensor, scale) -> torch.Tensor:
    """K2: the exact decode ``q * scale`` in f32 of an int8 leaf and its
    0-d f32 scale (a float is taken as one); a NaN scale poisons the
    whole leaf with ``0x7FC00000``. One launch on the card (a one-segment
    :func:`dequantize_q8_group`)."""
    if q.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {q.dtype}")
    scale = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    if scale.numel() != 1:
        raise ValueError(f"scale must be one element, got {tuple(scale.shape)}")
    if q.numel() == 0:
        return torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    if device_kind(q) == "cpu":
        return _dequantize_q8_plain(q, scale)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dequantize_q8_group(q.contiguous().reshape(-1), scale.reshape(1).contiguous(),
                        [q.numel()], out.view(-1))
    return out


# -- K3: f32 -> bf16 cast -----------------------------------------------------
#
# One launch casts a table of segments (per leaf: source, element count,
# offset in the group's bf16 buffer), reading each f32 leaf in place.


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


def _cast_bf16_group_plain(leaves: Sequence[torch.Tensor],
                           out: torch.Tensor) -> None:
    """The JAX pack's sequence: the leaves concatenated in f32, one cast."""
    if leaves:
        out.copy_(_cast_bf16_plain(torch.cat([l.float().reshape(-1)
                                              for l in leaves])))


def cast_bf16_group(leaves: Sequence[torch.Tensor], out: torch.Tensor) -> None:
    """:func:`cast_bf16` over every leaf of a plan group at once, into the
    group's bf16 wire buffer: ``out`` (contiguous 1-D bf16, the leaves'
    element count) gets the words concatenated in leaf order. Bit-identical
    to casting the leaves' f32 concatenation. On the card: one K3 launch
    (per 64 leaves) that reads each f32 leaf in place; a leaf that is
    not contiguous f32 (a native bf16 leaf of a mixed group) is copied to
    f32 first, which keeps its bits (bf16 -> f32 is exact)."""
    n = sum(l.numel() for l in leaves)
    _check_flat(out, "out", torch.bfloat16, n, out.device)
    _check_leaves(leaves, out.device)
    if device_kind(out) == "cpu":
        _cast_bf16_group_plain(leaves, out)
        return
    if not leaves:
        return
    xs = [_f32(l) for l in leaves]
    rows: List[int] = []
    for x, off in zip(xs, _offsets([x.numel() for x in xs])):
        rows += (x.data_ptr(), x.numel(), off)
    st, o = _stream(out), out.data_ptr()
    _launch_seg("cast_bf16", "tft_cast_bf16_seg", array.array("q", rows), 3,
                lambda b: (o, st))


def cast_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16, round to nearest even, canonical NaN; the bf16 wire's
    pack cast. One launch on the card (a one-segment
    :func:`cast_bf16_group`)."""
    if x.numel() == 0:
        return torch.zeros(x.shape, dtype=torch.bfloat16, device=x.device)
    if device_kind(x) == "cpu":
        return _cast_bf16_plain(x)
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    cast_bf16_group([x], out.view(-1))
    return out


# Plain versions by kernel name (the names of launch_counts), for holding
# a kernel against its plain version on the same (CUDA) inputs; and over a
# plan group.
plain = {
    "q8_absmax": _q8_absmax_plain,
    "q8_quantize": _q8_quantize_plain,
    "q8_dequantize": _dequantize_q8_plain,
    "cast_bf16": _cast_bf16_plain,
}
plain_group = {
    "q8_absmax": _q8_absmax_group_plain,
    "quantize_q8_ef": _quantize_q8_ef_group_plain,
    "quantize_q8": _quantize_q8_group_plain,
    "q8_dequantize": _dequantize_q8_group_plain,
    "cast_bf16": _cast_bf16_group_plain,
}

"""The int8 wire format of the quantized compression modes: per-leaf
symmetric int8 quantization with error feedback, and the member-wise
dequantize-average of gathered payloads.

The port of ``torchft_tpu/quantize.py``, shared by
``PipelinedDDP(compress="q8" | "int8", transport="legacy")``. The JAX
package runs both functions as jitted ``jnp`` programs; the port runs
them through the wire kernels of :mod:`.ops.quantize_kernels`, whose
arithmetic is the same contract bit for bit on finite data (the numpy
oracle of the native ``plan_pack_ef``): on the card one K1a and one K1b
launch quantize every leaf (a launch per 64 leaves) and one K2 launch
decodes them; on the CPU the kernels' plain versions run.

Every output leaf is a view of one flat buffer per kind (int8 codes, f32
scales, decoded values, carry), in leaf order: the layout a
device-packed allgather ships by exact dtype, and what
:func:`flat_buffer` finds again without a copy.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ._tree import flatten, unflatten
from .ops import quantize_kernels as qk
from .ops.quantize_kernels import _CANON_NAN_BITS


def flat_buffer(leaves: Sequence[torch.Tensor],
                dtype: torch.dtype) -> Optional[torch.Tensor]:
    """The contiguous 1-D ``dtype`` tensor whose consecutive slices the
    ``leaves`` are, in order and covering it exactly (as :func:`_views`
    makes them), or None. Lets a consumer hand the whole group to one
    launch or one copy instead of concatenating it again."""
    if not leaves:
        return None
    first = leaves[0]
    base = first._base if first._base is not None else first
    if (base.dtype != dtype or base.dim() != 1 or not base.is_contiguous()
            or base.numel() != sum(l.numel() for l in leaves)):
        return None
    ptr, off = base.untyped_storage().data_ptr(), base.storage_offset()
    for l in leaves:
        if (l.dtype != dtype or not l.is_contiguous()
                or l.untyped_storage().data_ptr() != ptr
                or l.storage_offset() != off):
            return None
        off += l.numel()
    return base


def _flat(leaves: Sequence[torch.Tensor], dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    """The leaves' flat ``dtype`` buffer: :func:`flat_buffer` when they are
    views of one, else their concatenation (a copy)."""
    buf = flat_buffer(leaves, dtype)
    if buf is not None:
        return buf
    if not leaves:
        return torch.empty(0, dtype=dtype, device=device)
    return torch.cat([l.to(device, dtype).reshape(-1) for l in leaves])


def _views(flat: torch.Tensor, shapes: Sequence[torch.Size]) -> List[torch.Tensor]:
    """Consecutive views of ``flat``, one per shape."""
    out, off = [], 0
    for shape in shapes:
        n = shape.numel()
        out.append(flat[off:off + n].view(shape))
        off += n
    return out


def quantize_with_feedback(tree: Any, residual: Any,
                           res_out: Optional[torch.Tensor] = None
                           ) -> Dict[str, Any]:
    """Per-leaf symmetric int8 quantization with error feedback.

    For each leaf: ``d = leaf(f32) + residual``; ``scale = max(|d|)/127``
    (floored at 1e-12); ``q = clip(round(d/scale))`` int8; ``dq = q*scale``
    (what is shipped); ``res = d - dq`` (the carry the CALLER owns: restore
    it on a discarded step, drop it on a heal). A leaf holding NaN or Inf
    gives codes 0, a NaN scale and an all-NaN ``dq`` and ``res`` (the
    kernels' canonical ``0x7FC00000``).

    Returns ``{"q", "scale", "dq", "res"}``, each a tree shaped like
    ``tree`` (``scale`` of 0-d leaves). ``q``, ``scale`` and ``dq`` are
    views of fresh flat buffers; ``res`` is a view of ``res_out`` (a flat
    f32 buffer of the tree's element count; allocated when None), and
    ``residual`` is only read. A caller that keeps two flat carries and
    passes the one it does not read as ``res_out`` rolls a discarded
    step back by not flipping them, without a copy. ``residual`` leaves
    that are views of one flat f32 buffer (a previous call's ``res``)
    are read in place."""
    leaves, treedef = flatten(tree)
    res_leaves, res_def = flatten(residual)
    if res_def != treedef:
        raise ValueError("residual must have the tree's structure")
    if not leaves:
        return {k: tree for k in ("q", "scale", "dq", "res")}
    dev = leaves[0].device
    shapes = [l.shape for l in leaves]
    counts = [l.numel() for l in leaves]
    n = sum(counts)
    res_in = _flat(res_leaves, torch.float32, dev)
    if res_out is None:
        res_out = torch.empty(n, dtype=torch.float32, device=dev)
    codes = torch.empty(n, dtype=torch.int8, device=dev)
    scales = torch.empty(len(leaves), dtype=torch.float32, device=dev)
    qk.quantize_q8_ef_group(leaves, res_in, codes, scales, res_out)
    dq = torch.empty(n, dtype=torch.float32, device=dev)
    qk.dequantize_q8_group(codes, scales, counts, dq)
    return {
        "q": unflatten(treedef, _views(codes, shapes)),
        "scale": unflatten(treedef, list(scales.unbind())),
        "dq": unflatten(treedef, _views(dq, shapes)),
        "res": unflatten(treedef, _views(res_out, shapes)),
    }


def cast_bf16_tree(tree: Any) -> Any:
    """``tree`` with its f32 leaves as bf16 views of one fresh buffer,
    cast by K3 (one launch per 64 leaves; its plain version on the CPU),
    other leaves as they are: the bf16 payload of the legacy transport
    and of ``AsyncDiLoCo(compress="bf16")``."""
    leaves, treedef = flatten(tree)
    idx = [i for i, l in enumerate(leaves) if l.dtype == torch.float32]
    if not idx:
        return tree
    buf = torch.empty(sum(leaves[i].numel() for i in idx),
                      dtype=torch.bfloat16, device=leaves[idx[0]].device)
    qk.cast_bf16_group([leaves[i] for i in idx], buf)
    out = list(leaves)
    for i, v in zip(idx, _views(buf, [leaves[i].shape for i in idx])):
        out[i] = v
    return unflatten(treedef, out)


def make_dequant_average() -> Callable[[Sequence[Any], float], Any]:
    """Member-wise dequantize-then-average of gathered ``{"q", "scale"}``
    entries: ``avg = (sum_i q_i * scale_i) / n``, the sum in member order,
    every operation its own rounding (as the JAX combine computes it).

    ``n`` must be the PARTICIPANT count, not the cohort size: a healing
    or spare member's entry arrives zeroed from ``Manager.allgather`` and
    must not dilute the divisor. Each entry decodes with one K2 launch on
    the card (a launch per 64 leaves), the plain version on the CPU.
    Every NaN of the average is written as ``0x7FC00000``, as K2 writes
    it: the card's add makes any NaN ``0x7FFFFFFF``, the CPU's keeps its
    operand's, and a poisoned member must give the same bits on both."""

    def combine(entries: Sequence[Any], n: float) -> Any:
        acc: Optional[torch.Tensor] = None
        treedef = shapes = None
        for e in entries:
            q, treedef = flatten(e["q"])
            s, _ = flatten(e["scale"])
            dev = q[0].device
            shapes = [l.shape for l in q]
            counts = [l.numel() for l in q]
            dq = torch.empty(sum(counts), dtype=torch.float32, device=dev)
            qk.dequantize_q8_group(_flat(q, torch.int8, dev),
                                   _flat(s, torch.float32, dev), counts, dq)
            acc = dq if acc is None else acc + dq
        assert acc is not None, "no entries to average"
        # a same-device 0-d divisor: a CPU scalar may become a reciprocal
        # multiply on the card, which rounds differently
        acc = acc / torch.full((), float(n), dtype=torch.float32,
                               device=acc.device)
        nan = torch.full((), _CANON_NAN_BITS, dtype=torch.int32,
                         device=acc.device).view(torch.float32)
        acc = torch.where(torch.isnan(acc), nan, acc)
        return unflatten(treedef, _views(acc, shapes))

    return combine

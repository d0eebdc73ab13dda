"""Flash attention: the fused forward (K4) and backward (K5) behind a
custom operator whose autograd is K5 (K6).

The port of ``torchft_tpu/ops/flash_attention.py``. Each kernel has two
bodies, picked by the tensors' device alone:

- a hand-written CUDA kernel (``csrc/flash_attention.cu``, built for
  ``sm_90a`` at first use) for tensors on the card: no (S, S) score matrix
  ever reaches device memory; it launches or raises, never falls back.
  The dtype picks the kernel (:func:`kernel_route`): bf16 runs the
  tensor-core kernels (forward and backward on ``wgmma`` with tiles
  brought in by TMA; they need every row 16-byte aligned:
  :func:`check_kernel_layout`), f32 the scalar f32 kernels (f32 on tensor
  cores would be TF32, too coarse for the f32 tolerance);
- a plain PyTorch version (:func:`flash_fwd_plain`,
  :func:`flash_bwd_plain`) for tensors on the CPU: dense torch code with
  the kernels' masks, roundings and formulas (no
  ``scaled_dot_product_attention``), which the tests hold against the
  JAX kernels and ``chip_smoke.py`` holds the CUDA kernels against.

Numerics (the JAX kernels' contract): ``sm_scale`` is folded into q
outside the Function as one f32 multiply rounded back to q's dtype;
scores are ``q_scaled . k^T`` accumulated in f32; the fast path (causal,
no window, ``block_q == block_k``) masks with the finite ``-1e30``, the
general path with ``-inf`` and ``isfinite`` guards (a row with every key
masked gives out 0 and lse ``-inf``); ``p`` is rounded to v's dtype
before ``p . v``; ``out = acc / max(l, 1e-30)``; ``lse = m + log(l)``.
The backward rebuilds ``p = exp(s - lse)`` (masked with a select), takes
``delta = rowsum(do * out)`` (the JAX package computes it outside its
kernel; the plain version does so in torch, the card's dq kernel folds it
into its first pass over each query tile and writes it for the dk/dv
kernel), and rounds ``ds = p * (dp - delta)`` once to q's dtype for both
``dk`` and ``dq``.

Tiles. ``block_q``/``block_k`` keep the JAX meaning: the query and key
tile sizes, and the fast path needs them equal. On the card the kernel's
query tile is 64 rows and its key tile 64 or 32 columns: ``None`` means
(64, 64), and other sizes raise there. On the CPU they are resolved as
the JAX package resolves them in interpret mode (auto 128, or 512 from a
padded length of 2048; clamped to the length rounded up to 8), which
only decides fast path or general path: the plain versions are dense.

Remat. K4/K5 launch through ctypes, which the dispatcher cannot see, so
the forward is the operator ``torchft_tpu_torch::flash_fwd`` (outputs
``out`` and ``lse``, the JAX package's ``flash_out`` and ``flash_lse``),
registered with K5 as its autograd. :func:`checkpoint_name` names any
other tensor (an identity operator; it returns a copy, as an operator's
output may not alias its input). :func:`save_only_these_names` builds
the ``context_fn`` of ``torch.utils.checkpoint.checkpoint`` that saves
exactly the named outputs and recomputes the rest, the counterpart of
``jax.checkpoint_policies.save_only_these_names``: with ``flash_out``
and ``flash_lse`` saved, the backward's replay skips K4.

``interpret=True`` runs the plain versions on any device because the
caller asks for it (the JAX argument's meaning: no compiled kernel);
``None`` keeps the dispatch by device. ``mesh``/``batch_axis``/
``head_axis``: in the JAX package the kernel then runs per shard under
``shard_map``; in the port each rank's q/k/v already are its shard (its
rows and heads, :mod:`torchft_tpu_torch.parallel`), so the call runs the
kernels on them as they are, once the named axes are checked against the
mesh.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    create_selective_checkpoint_contexts,
)

from ._lib import _kernels, device_kind
from ._lib import stream as _stream

_NEG_LARGE = -1e30
# what the kernels take on the card: dtype -> (its code at the C entry
# points, the kernels that code selects there)
KERNEL_ROUTES = {torch.float32: (0, "scalar"), torch.bfloat16: (1, "mma")}
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_BLOCK_Q = 64
KERNEL_BLOCKS_K = (64, 32)


class FlashConfig(NamedTuple):
    causal: bool
    window: Optional[int]
    block_q: int
    block_k: int
    interpret: bool = False  # the plain versions on any device

    @property
    def fast(self) -> bool:
        """The split-diagonal path: finite mask, no guards."""
        return self.causal and self.window is None and \
            self.block_q == self.block_k


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def resolve_blocks(
    S: int, device: torch.device, block_q: Optional[int],
    block_k: Optional[int],
) -> Tuple[int, int]:
    """The (block_q, block_k) a call runs with (see the module docstring)."""
    if device.type == "cuda":
        bq = KERNEL_BLOCK_Q if block_q is None else block_q
        bk = KERNEL_BLOCKS_K[0] if block_k is None else block_k
        if bq != KERNEL_BLOCK_Q or bk not in KERNEL_BLOCKS_K:
            raise ValueError(
                f"the CUDA kernels take block_q {KERNEL_BLOCK_Q} and block_k "
                f"in {KERNEL_BLOCKS_K}, got ({bq}, {bk})"
            )
        return bq, bk
    s8 = _cdiv(S, 8) * 8
    auto = 512 if s8 >= 2048 else 128
    return min(block_q or auto, s8), min(block_k or auto, s8)


# -- plain versions -------------------------------------------------------------


def _live(S: int, cfg: FlashConfig, device: torch.device) -> Optional[torch.Tensor]:
    """(S, S) bool mask of live (query, key) pairs, or None if all are."""
    if not cfg.causal and cfg.window is None:
        return None
    pos = torch.arange(S, device=device)
    diff = pos[:, None] - pos[None, :]  # q_pos - k_pos
    ok = diff >= 0 if cfg.causal else torch.ones_like(diff, dtype=torch.bool)
    if cfg.window is not None:
        ok = ok & (diff < cfg.window)
    return ok


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, H, S, S) f32 scores of (B, S, H, D) inputs: each element
    widened exactly to f32, then an f32 product."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())


def flash_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: FlashConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's plain version: q pre-scaled, (B, S, H, D) each ->
    ``(out (B, S, H, D) in q's dtype, lse (B, H, S) f32)``."""
    S = q.shape[1]
    s = _scores(q, k)
    ok = _live(S, cfg, q.device)
    neg = _NEG_LARGE if cfg.fast else float("-inf")
    if ok is not None:
        s = torch.where(ok, s, torch.full((), neg, device=s.device))
    m = s.amax(dim=-1)
    if cfg.fast:
        p = torch.exp(s - m[..., None])
    else:
        safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.where(torch.isfinite(s), torch.exp(s - safe_m[..., None]),
                        torch.zeros_like(s))
    l_safe = p.sum(dim=-1).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = (acc / l_safe.transpose(1, 2)[..., None]).to(q.dtype)
    lse = m + torch.log(l_safe)
    if not cfg.fast:
        lse = torch.where(torch.isfinite(m), lse,
                          torch.full((), float("-inf"), device=m.device))
    return out, lse


def flash_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, cfg: FlashConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's plain version: ``(dq, dk, dv)`` in q's, k's and v's dtypes
    from q (pre-scaled), k, v, do (B, S, H, D), lse and delta (B, H, S)."""
    S = q.shape[1]
    p = torch.exp(_scores(q, k) - lse[..., None])
    ok = _live(S, cfg, q.device)
    if ok is not None:  # a select: 0 * inf would give NaN
        p = torch.where(ok, p, torch.zeros((), device=p.device))
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- kernels ---------------------------------------------------------------------


def kernel_route(dtype: torch.dtype) -> str:
    """The kernels a call on the card runs for q, k, v of ``dtype``:
    ``"mma"`` (bf16: the tensor-core kernels) or ``"scalar"`` (f32: the
    scalar f32 FMA kernels; f32 products on tensor cores would be TF32).
    A dispatch by dtype, not a fallback: whichever kernel is picked
    launches or the call raises. Raises TypeError for any other dtype."""
    if dtype not in KERNEL_ROUTES:
        raise TypeError(
            f"the CUDA kernels take {sorted(map(str, KERNEL_ROUTES))}, "
            f"got {dtype}"
        )
    return KERNEL_ROUTES[dtype][1]


def check_kernel_layout(*ts: torch.Tensor) -> None:
    """Raises ValueError unless each tensor's address and (batch, seq,
    head) strides are 16-byte aligned, as the tensor-core kernels' row
    copies need (the TMA tensor maps, and the dq kernel's 16-byte loads
    of do and out for delta). The qkv split of a (B, S, 3HD)
    projection is: its strides and offsets are multiples of the head dim.
    A misaligned view raises rather than being copied."""
    for t in ts:
        size = t.element_size()
        if t.data_ptr() % 16 or any(s * size % 16 for s in t.stride()[:3]):
            raise ValueError(
                "the tensor-core kernels need 16-byte aligned rows: address "
                f"{t.data_ptr():#x} (storage offset {t.storage_offset()}), "
                f"strides {tuple(t.stride())} of {t.dtype}"
            )


def _check_kernel_inputs(*ts: torch.Tensor) -> None:
    q = ts[0]
    for t in ts:
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(
                "q, k, v (and do) must share device, dtype and shape; got "
                f"{[(tuple(t.shape), t.dtype, str(t.device)) for t in ts]}"
            )
    if kernel_route(q.dtype) == "mma":
        check_kernel_layout(*ts)
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the CUDA kernels take head_dim in {KERNEL_HEAD_DIMS}, got "
            f"{q.shape[-1]}"
        )


def _last_dim_dense(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _kernel_args(cfg: FlashConfig, ts) -> list:
    B, S, H, D = ts[0].shape
    strides = [s for t in ts for s in t.stride()[:3]]
    return [KERNEL_ROUTES[ts[0].dtype][0], B, S, H, D,
            (ctypes.c_int64 * len(strides))(*strides), int(cfg.causal),
            cfg.window or 0, cfg.block_k, int(cfg.fast), _stream(ts[0])]


def flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: FlashConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: ``(out, lse)`` of pre-scaled q and k, v, all (B, S, H, D); one
    launch on the card."""
    if cfg.interpret or device_kind(q) == "cpu":
        return flash_fwd_plain(q, k, v, cfg)
    q, k, v = (_last_dim_dense(t) for t in (q, k, v))
    _check_kernel_inputs(q, k, v)
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if q.numel():
        _kernels.launch("flash_fwd", "tft_flash_fwd", q.data_ptr(),
                        k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        lse.data_ptr(), *_kernel_args(cfg, (q, k, v)))
    return out, lse


def flash_delta_plain(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(do * out)`` as (B, H, S) f32, as the JAX package
    computes it outside its kernel, summed as one chain of f32 adds in d
    order: the order in which the card's dq kernel folds it (with bf16
    inputs each product is exact in f32, so the two agree bit for bit),
    and that of the f32 matmul giving ``dp``. In window 1, where out = v
    and ``ds = dp - delta`` is all rounding, that keeps the kernels and
    this version on the same bits."""
    prod = do.float() * out.float()
    acc = torch.zeros(prod.shape[:-1], dtype=torch.float32, device=prod.device)
    for d in range(prod.shape[-1]):
        acc = acc + prod[..., d]
    return acc.transpose(1, 2).contiguous()


def flash_bwd_kernels(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, cfg: FlashConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's two launches on the card: ``(dq, dk, dv, delta)``. The dq
    kernel runs first and writes ``delta`` (B, H, S) f32, which the dk/dv
    kernel then reads on the same stream."""
    if device_kind(q) != "cuda":
        raise ValueError(f"the K5 kernels take tensors on the card, got {q.device}")
    q, k, v, do, out = (_last_dim_dense(t) for t in (q, k, v, do, out))
    _check_kernel_inputs(q, k, v, do, out)
    lse = lse.contiguous()
    B, S, H, _ = q.shape
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if q.numel():
        _kernels.launch("flash_bwd", "tft_flash_bwd_dq", q.data_ptr(),
                        k.data_ptr(), v.data_ptr(), do.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dq.data_ptr(), *_kernel_args(cfg, (q, k, v, do, out)))
        _kernels.launch("flash_bwd", "tft_flash_bwd_dkdv", q.data_ptr(),
                        k.data_ptr(), v.data_ptr(), do.data_ptr(),
                        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), *_kernel_args(cfg, (q, k, v, do)))
    return dq, dk, dv, delta


def flash_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, cfg: FlashConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5: ``(dq, dk, dv)``; two launches on the card (dq with delta,
    then dk/dv: :func:`flash_bwd_kernels`)."""
    if cfg.interpret or device_kind(q) == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, flash_delta_plain(out, do),
                               cfg)
    return flash_bwd_kernels(q, k, v, out, lse, do, cfg)[:3]


@torch.library.custom_op("torchft_tpu_torch::flash_fwd", mutates_args=())
def _flash_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    window: Optional[int], block_q: int, block_k: int, interpret: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 as an operator: ``(out, lse)`` of pre-scaled q and k, v."""
    return flash_fwd(q, k, v, FlashConfig(causal, window, block_q, block_k,
                                          interpret))


def _flash_setup(ctx, inputs, output) -> None:
    q, k, v, *cfg = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.cfg = FlashConfig(*cfg)


def _flash_backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_bwd(q, k, v, out, lse, dout, ctx.cfg)
    return dq, dk, dv, None, None, None, None, None


_flash_op.register_autograd(_flash_backward, setup_context=_flash_setup)


@torch.library.custom_op("torchft_tpu_torch::checkpoint_name", mutates_args=())
def _checkpoint_name_op(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


_checkpoint_name_op.register_autograd(
    lambda ctx, grad: (grad, None),
    setup_context=lambda ctx, inputs, output: None,
)


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` named ``name`` for :func:`save_only_these_names` (a copy)."""
    return _checkpoint_name_op(x, name)


def save_only_these_names(*names: str) -> Callable:
    """The ``context_fn`` for ``torch.utils.checkpoint.checkpoint(...,
    use_reentrant=False)`` that saves the outputs named ``names`` and
    recomputes everything else: the flash operator's outputs are
    ``flash_out`` and ``flash_lse`` (saved together, which skips K4 in
    the replay), a :func:`checkpoint_name` output its name."""
    wanted = frozenset(names)
    flash = torch.ops.torchft_tpu_torch.flash_fwd.default
    named = torch.ops.torchft_tpu_torch.checkpoint_name.default

    def policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
        if op is flash and wanted & {"flash_out", "flash_lse"}:
            return CheckpointPolicy.MUST_SAVE
        if op is named and args[1] in wanted:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return lambda: create_selective_checkpoint_contexts(policy)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    window: Optional[int] = None,
    interpret: Optional[bool] = None,
    mesh: Optional[Any] = None,
    batch_axis: Optional[str] = None,
    head_axis: Optional[str] = None,
) -> torch.Tensor:
    """Fused multi-head attention on (B, S, H, head_dim) q, k, v; returns
    (B, S, H, head_dim) in q's dtype.

    ``causal``: the autoregressive mask. ``window``: sliding-window
    attention, each query sees the ``window`` most recent keys
    (``q_pos - k_pos < window``); requires ``causal``. ``sm_scale``:
    default ``head_dim ** -0.5``, folded into q as one f32 multiply
    rounded to q's dtype (exact for power-of-two scales). ``block_q``,
    ``block_k``: tile sizes (module docstring). On the card: bf16 or f32
    inputs, head_dim 64 or 128; anything else raises. ``interpret=True``:
    the plain versions on any device (module docstring). ``mesh``,
    ``batch_axis``, ``head_axis``: the axes this rank's rows and heads
    are split over (module docstring); checked, not re-sharded."""
    if mesh is not None:
        for axis in (batch_axis, head_axis):
            if axis is not None and axis not in mesh.shape:
                raise ValueError(
                    f"axis {axis!r} is not in the mesh {mesh.shape}")
    B, S, H, D = q.shape
    if sm_scale is None:
        sm_scale = D ** -0.5
    if window is not None:
        if not causal:
            raise ValueError(
                "window requires causal=True (one-sided local attention)"
            )
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    interpret = bool(interpret)
    bq, bk = resolve_blocks(S, torch.device("cpu") if interpret else q.device,
                            block_q, block_k)
    q_scaled = (q.float() * sm_scale).to(q.dtype)
    out, _ = _flash_op(q_scaled, k, v, bool(causal),
                       None if window is None else int(window), bq, bk,
                       interpret)
    return out


__all__ = [
    "FlashConfig",
    "check_kernel_layout",
    "checkpoint_name",
    "flash_attention",
    "flash_bwd",
    "flash_bwd_kernels",
    "flash_bwd_plain",
    "flash_delta_plain",
    "flash_fwd",
    "flash_fwd_plain",
    "kernel_route",
    "resolve_blocks",
    "save_only_these_names",
]

"""Context parallelism: ring attention and Ulysses over a ``seq`` mesh axis.

The port of ``torchft_tpu/context_parallel.py``. Each rank holds its own
block of the sequence (:func:`split_sequence`), so q, k and v reach these
functions as the rank's local ``(B, S/n, H, head_dim)`` blocks (its data
rows and, with a ``model`` axis, its heads) and leave as the local
output block; the JAX functions' ``shard_map`` is the process layout
itself.

- :func:`ring_attention` (Liu et al., arXiv:2310.01889): the rank's query
  block stays put while k/v blocks rotate round the ring
  (:func:`~.parallel.ppermute`, send to ``rank + 1``, receive from
  ``rank - 1``) and an f32 online softmax folds them in one at a time.
  Plain torch, as the JAX ring is plain ``jnp``: no kernel of its own.
- :func:`ulysses_attention` (DeepSpeed-Ulysses, arXiv:2309.14509): one
  :func:`~.parallel.all_to_all` re-shards sequence -> heads, each rank runs
  full-sequence attention on ``H/n`` heads (through the flash kernels,
  K4/K5, when ``use_flash``; else dense f32 softmax) and a second
  all-to-all re-shards back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .ops.flash_attention import flash_attention
from .parallel import Mesh, all_to_all, ppermute


def split_sequence(x: torch.Tensor, mesh: Mesh, seq_axis: str = "seq",
                   dim: int = 1) -> torch.Tensor:
    """This rank's block of a whole sequence along ``dim`` (a view);
    raises unless the length divides by the axis size."""
    n = mesh.axis_size(seq_axis)
    S = x.shape[dim]
    if S % n:
        raise ValueError(
            f"sequence length {S} not divisible by {seq_axis}={n}")
    return x.narrow(dim, mesh.axis_index(seq_axis) * (S // n), S // n)


def _check_axes(mesh: Mesh, *axes: Optional[str]) -> None:
    for a in axes:
        if a is not None and a not in mesh.shape:
            raise ValueError(f"axis {a!r} is not in the mesh {mesh.shape}")


def _ring_step(q32: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor,
               m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
               q_pos: torch.Tensor, kv_pos: Optional[torch.Tensor],
               scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One k/v block folded into the online-softmax state (m, l, acc);
    ``kv_pos`` None: no causal mask."""
    zero = torch.zeros((), device=q32.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float()) * scale
    if kv_pos is not None:
        scores = torch.where(q_pos[:, None] >= kv_pos[None, :], scores,
                             torch.full((), float("-inf"), device=q32.device))
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # a block masked whole keeps m = -inf: guard (-inf) - (-inf)
    safe_m = torch.where(torch.isfinite(m_new), m_new, zero)
    p = torch.exp(scores - safe_m[..., None])
    p = torch.where(torch.isfinite(scores), p, zero)
    corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), zero)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p, v_blk.float())
    return m_new, l_new, acc_new


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh,
    seq_axis: str = "seq",
    batch_axis: Optional[str] = "data",
    head_axis: Optional[str] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Sequence-sharded self-attention on this rank's blocks.

    Args:
        q, k, v: the rank's ``(B, S/n, H, head_dim)`` blocks, block
            ``axis_index(seq_axis)`` of the sequence (``batch_axis`` and
            ``head_axis`` name the axes its rows and heads are split over,
            or None; both are the layout the caller already holds).
    Returns:
        the rank's ``(B, S/n, H, head_dim)`` output block, q's dtype.

    Each block's update is recomputed in the backward
    (``torch.utils.checkpoint``): autograd keeps the online-softmax
    state of each step, not its several (S/n, S/n) f32 score tensors,
    with which four ranks at bench.py's big LM (B4, S 2048, 16 heads)
    ran one H100 out of memory."""
    _check_axes(mesh, seq_axis, batch_axis, head_axis)
    n = mesh.axis_size(seq_axis)
    blk = mesh.axis_index(seq_axis)
    B, Sl, H, Dh = q.shape
    dev = q.device
    q32 = q.float()
    q_pos = blk * Sl + torch.arange(Sl, device=dev)
    m = torch.full((B, H, Sl), float("-inf"), device=dev)
    l = torch.zeros((B, H, Sl), device=dev)
    acc = torch.zeros((B, H, Sl, Dh), device=dev)
    perm = [(i, (i + 1) % n) for i in range(n)]
    k_blk, v_blk = k, v
    for s in range(n):
        # ring step s: this rank holds kv block (blk - s) mod n
        kv_pos = (((blk - s) % n) * Sl + torch.arange(Sl, device=dev)
                  if causal else None)
        args = (q32, k_blk, v_blk, m, l, acc, q_pos, kv_pos, Dh ** -0.5)
        if torch.is_grad_enabled():
            m, l, acc = checkpoint(_ring_step, *args, use_reentrant=False)
        else:
            m, l, acc = _ring_step(*args)
        if s < n - 1:  # the last rotation's blocks would go unused
            k_blk = ppermute(k_blk, mesh, seq_axis, perm)
            v_blk = ppermute(v_blk, mesh, seq_axis, perm)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]  # (B, H, Sl, Dh)
    return out.transpose(1, 2).to(q.dtype)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh,
    seq_axis: str = "seq",
    batch_axis: Optional[str] = "data",
    head_axis: Optional[str] = None,
    causal: bool = True,
    use_flash: bool = True,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Sequence-sharded self-attention through head/sequence all-to-alls.

    Args:
        q, k, v: the rank's ``(B, S/n, H_local, head_dim)`` blocks;
            ``H_local`` (H, or H/tp under a ``head_axis``) must divide by
            the ``seq_axis`` size.
        use_flash: the full-sequence attention through the flash kernels
            (K4/K5 on the card) instead of dense f32 softmax.
        block_q, block_k: flash tile overrides (``flash_attention``'s).
    Returns:
        the rank's ``(B, S/n, H_local, head_dim)`` output block."""
    _check_axes(mesh, seq_axis, batch_axis, head_axis)
    n = mesh.axis_size(seq_axis)
    local_heads = q.shape[2]
    if local_heads % n:
        raise ValueError(
            f"per-device head count {local_heads} not divisible by "
            f"{seq_axis}={n} (Ulysses shards heads during attention)"
        )
    # (B, S/n, H, D) -> (B, S, H/n, D): heads split over the axis, the
    # whole sequence gathered
    qg, kg, vg = (all_to_all(t, mesh, seq_axis, 2, 1) for t in (q, k, v))
    if use_flash:
        out = flash_attention(qg, kg, vg, causal=causal, block_q=block_q,
                              block_k=block_k)
    else:
        S = qg.shape[1]
        scale = qg.shape[-1] ** -0.5
        scores = torch.einsum("bqhd,bkhd->bhqk", qg.float(), kg.float()) * scale
        if causal:
            mask = torch.tril(torch.ones(S, S, dtype=torch.bool,
                                         device=qg.device))
            scores = torch.where(mask, scores,
                                 torch.full((), float("-inf"),
                                            device=qg.device))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vg.float()).to(qg.dtype)
    # (B, S, H/n, D) -> (B, S/n, H, D)
    return all_to_all(out, mesh, seq_axis, 1, 2)


__all__ = ["ring_attention", "split_sequence", "ulysses_attention"]

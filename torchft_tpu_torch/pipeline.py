"""Pipeline parallelism: the GPipe schedule over a ``pipe`` mesh axis.

The port of ``torchft_tpu/pipeline.py``. Layer params are stacked on a
leading layer dimension (:func:`stack_blocks`) and split over ``pipe``
(:func:`stage_specs`), so each rank holds only its stage's layers.
:func:`pipeline_blocks` runs the JAX package's tick loop: M microbatches
drain through S stages in M + S - 1 ticks, stage 0 injects, the last
stage commits, and each stage hands its output to the next; at the end
the last stage's outputs reach every stage as a sum over the axis of the
masked buffer (``psum`` of the JAX function).

In the JAX package autodiff transposes the loop. Here the loop is one
``torch.autograd.Function``: its forward keeps each tick's graph, and its
backward replays the ticks in reverse on every rank, in the same order,
receiving each output's cotangent from the next stage and sending each
input's to the previous one (a send or a receive that only the
cotangents make would otherwise be pruned from one rank's backward and
hang its peer). The final sum's backward is the all-reduce of the
cotangents (every rank computes the same loss; the gradient step's
``1 / mesh.size`` seed makes the sum right). A tick where a stage holds
no microbatch runs nothing and sends nothing.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from ._tree import flatten, tree_map, unflatten
from .parallel import Mesh, _raw_all_reduce, send_recv


def stack_blocks(block_params: list) -> Any:
    """A list of identically-structured per-layer trees as one tree with
    a leading layer dimension."""
    flat = [flatten(b) for b in block_params]
    treedef = flat[0][1]
    if any(d != treedef for _, d in flat):
        raise ValueError("blocks differ in structure")
    return unflatten(treedef, [torch.stack(ls)
                               for ls in zip(*(l for l, _ in flat))])


def stage_specs(stacked_params: Any, axis: str = "pipe") -> Any:
    """Specs for :func:`stack_blocks` output: ``axis`` on the leading
    layer dimension, replicated behind it."""
    return tree_map(lambda leaf: (axis,) + (None,) * (leaf.dim() - 1),
                    stacked_params)


def _valid(stage: int, tick: int, microbatches: int) -> bool:
    return 0 <= tick - stage < microbatches


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, block_fn, treedef, mesh, axis, microbatches,
                *leaves):
        S, M = mesh.axis_size(axis), microbatches
        stage = mesh.axis_index(axis)
        n_local = leaves[0].shape[0]
        stream = x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))
        mb_shape = stream.shape[1:]
        with torch.enable_grad():
            work = [l.detach().requires_grad_(l.requires_grad) for l in leaves]
            layers = [unflatten(treedef, [w[i] for w in work])
                      for i in range(n_local)]
        ticks = {}  # microbatch -> (stage input, stage output)
        outs: List[Optional[torch.Tensor]] = [None] * M
        for t in range(M + S - 1):
            if not _valid(stage, t, M):
                continue
            m = t - stage
            if stage == 0:
                h = stream[m].detach()
            else:
                h = torch.empty(mb_shape, dtype=x.dtype, device=x.device)
                send_recv(mesh, axis, None, (h, stage - 1), m)
            with torch.enable_grad():
                h.requires_grad_(True)
                y = h
                for p in layers:
                    y = block_fn(p, y)
            ticks[m] = (h, y)
            if stage < S - 1:
                send_recv(mesh, axis, (y.detach(), stage + 1), None, m)
            else:
                outs[m] = y.detach()
        buf = (torch.stack(outs) if stage == S - 1
               else torch.zeros_like(stream))
        out = _raw_all_reduce(buf, mesh, axis)
        ctx.mesh, ctx.axis, ctx.M, ctx.stage = mesh, axis, M, stage
        ctx.ticks, ctx.work, ctx.x_shape = ticks, work, x.shape
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, M, stage = ctx.mesh, ctx.axis, ctx.M, ctx.stage
        S = mesh.axis_size(axis)
        g = _raw_all_reduce(g.contiguous(), mesh, axis)
        g = g.reshape((M, g.shape[0] // M) + tuple(g.shape[1:]))
        dx = torch.zeros_like(g) if stage == 0 else None
        dleaves = [None] * len(ctx.work)
        for t in reversed(range(M + S - 1)):
            if not _valid(stage, t, M):
                continue
            m = t - stage
            h, y = ctx.ticks.pop(m)
            if stage == S - 1:
                dy = g[m]
            else:
                dy = torch.empty_like(y)
                send_recv(mesh, axis, None, (dy, stage + 1), m)
            wanted = [h] + [w for w in ctx.work if w.requires_grad]
            grads = torch.autograd.grad(y, wanted, dy, allow_unused=True)
            dh, rest = grads[0], iter(grads[1:])
            for i, w in enumerate(ctx.work):
                if not w.requires_grad:
                    continue
                gw = next(rest)
                if gw is not None:
                    dleaves[i] = gw if dleaves[i] is None else dleaves[i] + gw
            if dh is None:
                dh = torch.zeros_like(h)
            if stage == 0:
                dx[m] = dh
            else:
                send_recv(mesh, axis, (dh, stage - 1), None, m)
        dleaves = [torch.zeros_like(w) if d is None and w.requires_grad else d
                   for d, w in zip(dleaves, ctx.work)]
        dx = (dx.reshape(ctx.x_shape) if dx is not None
              else torch.zeros(ctx.x_shape, dtype=g.dtype, device=g.device))
        return (dx, None, None, None, None, None, *dleaves)


def pipeline_blocks(
    block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,
    x: torch.Tensor,
    *,
    mesh: Mesh,
    axis: str = "pipe",
    microbatches: int,
    data_axis: Optional[str] = None,
) -> torch.Tensor:
    """Run a stack of identical layers as a GPipe pipeline.

    Args:
        block_fn: ``(one_layer_params, activations) -> activations``;
            shapes must be preserved.
        stacked_params: this rank's stage: its block of the
            :func:`stack_blocks` tree under :func:`stage_specs` (the
            whole stack's layer count must divide by the axis size, which
            ``shard_pytree`` checks).
        x: this rank's ``(B, ...)`` activations (its ``data_axis`` block
            under DP x PP, the microbatch split happens on it); B divisible
            by ``microbatches``. Only stage 0 reads them.
        microbatches: GPipe M; the bubble is (S - 1) / (M + S - 1).
    Returns:
        ``(B, ...)`` activations on every stage of the axis."""
    if axis not in mesh.shape:
        raise ValueError(f"axis {axis!r} is not in the mesh {mesh.shape}")
    if data_axis is not None and data_axis not in mesh.shape:
        raise ValueError(f"axis {data_axis!r} is not in the mesh {mesh.shape}")
    local_batch = x.shape[0]
    if local_batch % microbatches:
        raise ValueError(
            f"per-shard batch {local_batch} not divisible by "
            f"{microbatches} microbatches"
        )
    leaves, treedef = flatten(stacked_params)
    if mesh.axis_size(axis) == 1:
        n_local = leaves[0].shape[0]
        for i in range(n_local):
            x = block_fn(unflatten(treedef, [l[i] for l in leaves]), x)
        return x
    return _Pipeline.apply(x, block_fn, treedef, mesh, axis, microbatches,
                           *leaves)


__all__ = ["pipeline_blocks", "stack_blocks", "stage_specs"]

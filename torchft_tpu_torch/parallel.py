"""Intra-replica-group parallelism: a mesh of processes, one per position.

The port of ``torchft_tpu/parallel.py``. The JAX package runs one process
per replica group over a device mesh and lets GSPMD insert the
collectives its ``PartitionSpec`` rules imply. In torch a mesh is
several processes (as ``torchrun`` starts them): each rank holds its own
block of every leaf as a plain tensor on its one device, and every
collective is explicit. Each rank of a replica group runs its own
:class:`~.manager.Manager` (``rank=r, world_size=N``), whose cross-group
ring carries that rank's shard (the reference's HSDP layout,
``ManagedDeviceMesh``).

:class:`Mesh` holds the axis names and sizes, this rank's coordinates
(rank ``r`` sits at ``numpy.unravel_index(r, sizes)``, the order
``jax.sharding.Mesh`` lays devices out in) and one process group per
axis, built directly on a ``PrefixStore`` (never through
``init_process_group``): gloo by default, NCCL on request (it needs one
card per rank). On gloo a card tensor is staged through pinned host
buffers, always; on NCCL it goes direct.

The five collectives over one axis (:func:`all_reduce`,
:func:`all_gather`, :func:`reduce_scatter`, :func:`all_to_all`,
:func:`ppermute`) are ``torch.autograd.Function`` s whose backward is the
forward's adjoint (``all_reduce`` for ``all_reduce``, ``reduce_scatter``
for ``all_gather`` and back, the inverse ``all_to_all`` and
permutation). With adjoints, a rank's gradient of its local copy of a
leaf is that copy's share of the objective ``sum over ranks of
seed * local loss``: :func:`build_grad_step` seeds every rank with
``1 / mesh.size`` and then sums each leaf's gradient over the axes the
leaf is not split over, which yields the gradient of the global mean
loss that the JAX package's jitted step returns (the psum GSPMD
inserts). The same rule holds whatever an axis does (data, tensor, seq,
pipe, expert), so no op needs the identity-forward / all-reduce-backward
pair of Megatron's convention.

Rules are per-leaf tuples mirroring ``PartitionSpec``: ``()`` is
replicated, ``(None, "model")`` splits dimension 1 over ``model``, and an
entry may itself be a tuple of axis names (split over their product, the
first outermost). Imports neither JAX nor ``torchft_tpu``.
"""

from __future__ import annotations

import threading
import time
from datetime import timedelta
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ._tree import flatten, unflatten
from .train_state import build_shard_apply_step

Spec = Tuple[Any, ...]


class Mesh:
    """One rank's view of a replica group's mesh: axis names and sizes,
    this rank's coordinates, and one process group per axis of size > 1
    (its members: the ranks that share every other coordinate)."""

    def __init__(self, axis_sizes: Mapping[str, int], rank: int,
                 groups: Dict[str, Any], backend: str) -> None:
        self.axis_names: Tuple[str, ...] = tuple(axis_sizes)
        self.shape: Dict[str, int] = dict(axis_sizes)
        self.rank = rank
        self.size = int(np.prod(list(self.shape.values()), dtype=np.int64))
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names,
            (int(c) for c in np.unravel_index(rank, tuple(self.shape.values())))))
        self.groups = groups
        self.backend = backend
        # intra-group collective accounting: op -> [calls, seconds, bytes]
        self.stats: Dict[str, List[float]] = {}
        self._tags: Dict[str, int] = {}
        self._pinned: Dict[Tuple[torch.dtype, int, int], torch.Tensor] = {}
        self._lock = threading.Lock()

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def has_axis(self, axis: Optional[str]) -> bool:
        """True when ``axis`` is a mesh axis of size > 1."""
        return axis is not None and self.shape.get(axis, 1) > 1

    def pop_stats(self) -> Dict[str, List[float]]:
        """The collectives' ``{op: [calls, seconds, bytes]}`` since the
        last pop."""
        with self._lock:
            out, self.stats = self.stats, {}
        return out

    def shutdown(self) -> None:
        for pg in self.groups.values():
            try:
                pg.shutdown()
            except Exception:  # noqa: BLE001 - a torn group is gone either way
                pass
        self.groups = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"

    # -- plumbing --

    def _next_tag(self, axis: str) -> int:
        tag = self._tags.get(axis, 0)
        self._tags[axis] = tag + 1
        return tag

    def _record(self, op: str, seconds: float, nbytes: int) -> None:
        with self._lock:
            row = self.stats.setdefault(op, [0, 0.0, 0])
            row[0] += 1
            row[1] += seconds
            row[2] += nbytes

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def _host(self, t: torch.Tensor, slot: int) -> torch.Tensor:
        """A pinned host buffer shaped like ``t`` (reused per dtype, size
        and slot): gloo's side of a card tensor."""
        key = (t.dtype, t.numel(), slot)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(t.numel(), dtype=t.dtype,
                                                  pin_memory=True)
        return buf.view(t.shape)


def make_mesh(
    axis_sizes: Optional[Mapping[str, int]] = None,
    *,
    rank: int,
    world_size: int,
    store: Any,
    prefix: str = "mesh",
    backend: str = "gloo",
    timeout: timedelta = timedelta(seconds=300),
) -> Mesh:
    """This rank's :class:`Mesh` over ``world_size`` processes.

    ``axis_sizes`` maps axis name -> size (their product must equal
    ``world_size``); default: every rank on one ``data`` axis. Axis name
    conventions: ``data`` (batch), ``model`` (tensor parallel), ``seq``
    (context parallel), ``pipe`` (pipeline), ``expert`` (experts).
    ``store``: a ``torch.distributed`` store every rank reaches (a
    ``TCPStore``, or a ``HashStore`` for ranks that are threads of one
    process); the groups' keys live under ``prefix``. Every rank must
    call this (each builds its groups in axis order, which rendezvous)."""
    import torch.distributed as dist

    if axis_sizes is None:
        axis_sizes = {"data": world_size}
    shape = tuple(axis_sizes.values())
    if int(np.prod(shape)) != world_size:
        raise ValueError(
            f"mesh {dict(axis_sizes)} needs {int(np.prod(shape))} devices, "
            f"have {world_size}"
        )
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a mesh of {world_size}")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    mesh = Mesh(axis_sizes, rank, {}, backend)
    for axis in mesh.axis_names:
        n = mesh.shape[axis]
        if n == 1:
            continue
        peers = ",".join(f"{a}{c}" for a, c in mesh.coords.items() if a != axis)
        sub = dist.PrefixStore(f"{prefix}/{axis}/{peers}", store)
        if backend == "gloo":
            pg = dist.ProcessGroupGloo(sub, mesh.coords[axis], n, timeout)
        else:
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            pg = dist.ProcessGroupNCCL(sub, mesh.coords[axis], n, opts)
        mesh.groups[axis] = pg
    return mesh


# -- raw collectives (no autograd) ----------------------------------------------

_HALF = (torch.bfloat16, torch.float16)


def _as_moved(t: torch.Tensor) -> torch.Tensor:
    """A pure data move ships 16-bit floats as their bytes (a uint8 view
    of twice the last dimension: gloo need not know the float type)."""
    return t.view(torch.uint8) if t.dtype in _HALF else t


def _reduce_dtype(t: torch.Tensor) -> torch.Tensor:
    """Reductions run in f32 for 16-bit floats (one rounding, at the end)."""
    return t.float() if t.dtype in _HALF else t


def _run(mesh: Mesh, axis: str, op: str, x: torch.Tensor, out: torch.Tensor,
         call: Callable[[Any, torch.Tensor, torch.Tensor], Any]) -> torch.Tensor:
    """Runs ``call(pg, out_buf, in_buf)`` on the axis group, staging card
    tensors through pinned host buffers on gloo; fills and returns
    ``out``."""
    pg = mesh.groups[axis]
    t0 = time.perf_counter()
    if mesh._staged(x):
        hin = mesh._host(x, 0)
        hin.copy_(x)
        hout = mesh._host(out, 1)
        call(pg, hout, hin).wait()
        out.copy_(hout)
    else:
        call(pg, out, x.contiguous()).wait()
    mesh._record(op, time.perf_counter() - t0,
                 x.numel() * x.element_size())
    return out


def _raw_all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    if not mesh.has_axis(axis):
        return x
    w = _reduce_dtype(x).contiguous()
    out = torch.empty_like(w)

    def call(pg, o, i):
        o.copy_(i)
        return pg.allreduce([o])

    return _run(mesh, axis, "all_reduce", w, out, call).to(x.dtype)


def _raw_all_gather(x: torch.Tensor, mesh: Mesh, axis: str,
                    dim: int) -> torch.Tensor:
    if not mesh.has_axis(axis):
        return x
    n = mesh.axis_size(axis)
    w = _as_moved(x.contiguous())
    out = torch.empty((n,) + tuple(w.shape), dtype=w.dtype, device=w.device)
    _run(mesh, axis, "all_gather", w, out,
         lambda pg, o, i: pg._allgather_base(o.view(-1), i.view(-1)))
    out = out.view(x.dtype) if w.dtype != x.dtype else out
    return torch.cat(out.unbind(0), dim=dim)


def _raw_reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str,
                        dim: int) -> torch.Tensor:
    if not mesh.has_axis(axis):
        return x
    n = mesh.axis_size(axis)
    L = x.shape[dim]
    if L % n:
        raise ValueError(f"dimension {dim} of size {L} not divisible by "
                         f"{axis}={n}")
    w = _reduce_dtype(x).movedim(dim, 0).contiguous()
    out = torch.empty((L // n,) + tuple(w.shape[1:]), dtype=w.dtype,
                      device=w.device)
    _run(mesh, axis, "reduce_scatter", w, out,
         lambda pg, o, i: pg._reduce_scatter_base(o, i))
    return out.movedim(0, dim).to(x.dtype)


def _raw_all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split: int,
                    concat: int) -> torch.Tensor:
    if not mesh.has_axis(axis):
        return x
    import torch.distributed as dist

    n = mesh.axis_size(axis)
    L = x.shape[split]
    if L % n:
        raise ValueError(f"dimension {split} of size {L} not divisible by "
                         f"{axis}={n}")
    xs = x.movedim(split, 0)
    w = _as_moved(xs.reshape((n, L // n) + tuple(xs.shape[1:])).contiguous())
    out = torch.empty_like(w)
    _run(mesh, axis, "all_to_all", w, out,
         lambda pg, o, i: pg.alltoall_base(o, i, [], [],
                                           dist.AllToAllOptions()))
    out = out.view(x.dtype) if w.dtype != x.dtype else out
    pieces = [p.movedim(0, split) for p in out.unbind(0)]
    return torch.cat(pieces, dim=concat)


def _raw_all_to_all_v(x: torch.Tensor, mesh: Mesh, axis: str,
                      in_splits: Sequence[int],
                      out_splits: Sequence[int]) -> torch.Tensor:
    """Rows ``x[sum(in_splits[:i]):][:in_splits[i]]`` go to rank ``i``;
    the rows from rank ``i`` (``out_splits[i]`` of them) land in rank
    order."""
    if not mesh.has_axis(axis):
        return x
    import torch.distributed as dist

    w = _as_moved(x.contiguous())
    out = torch.empty((sum(out_splits),) + tuple(w.shape[1:]), dtype=w.dtype,
                      device=w.device)
    _run(mesh, axis, "all_to_all", w, out,
         lambda pg, o, i: pg.alltoall_base(o, i, list(out_splits),
                                           list(in_splits),
                                           dist.AllToAllOptions()))
    return out.view(x.dtype) if w.dtype != x.dtype else out


def send_recv(mesh: Mesh, axis: str, send: Optional[Tuple[torch.Tensor, int]],
              recv: Optional[Tuple[torch.Tensor, int]], tag: int) -> None:
    """Point to point on one axis: ``send = (tensor, dst)`` and ``recv =
    (buffer, src)`` (axis indices; either may be None), both posted before
    either is waited on; ``recv``'s buffer is filled in place. No
    autograd: the pipeline drives its own backward."""
    pg = mesh.groups[axis]
    t0 = time.perf_counter()
    works, hrecv, nbytes = [], None, 0
    if send is not None:
        t, dst = send
        w = _as_moved(t.contiguous())
        if mesh._staged(t):
            h = mesh._host(w, 0)
            h.copy_(w)
            w = h
        works.append(pg.send([w], dst, tag))
        nbytes += t.numel() * t.element_size()
    if recv is not None:
        buf, src = recv
        hrecv = _as_moved(buf)
        if mesh._staged(buf):
            hrecv = mesh._host(hrecv, 1)
        works.append(pg.recv([hrecv], src, tag))
    for wk in works:
        wk.wait()
    if recv is not None and mesh._staged(recv[0]):
        _as_moved(recv[0]).copy_(hrecv)
    mesh._record("send_recv", time.perf_counter() - t0, nbytes)


def _raw_ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
                  perm: Sequence[Tuple[int, int]], tag: int) -> torch.Tensor:
    """Sends ``x`` to ``dst`` for each ``(me, dst)`` pair and receives
    from ``src`` for each ``(src, me)``; a rank that receives nothing
    gets zeros (``lax.ppermute``'s meaning)."""
    if not mesh.has_axis(axis):
        return x.clone() if any(s == d for s, d in perm) else torch.zeros_like(x)
    me = mesh.axis_index(axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    if not dst and not src:
        return out
    pg = mesh.groups[axis]
    t0 = time.perf_counter()
    w = _as_moved(x.contiguous())
    staged = mesh._staged(x)
    send = recv = None
    if staged:
        send = mesh._host(w, 0)
        send.copy_(w)
        recv = mesh._host(w, 1)
    else:
        send = w
        recv = _as_moved(out)
    works = []
    for d in dst:
        if d == me:
            continue
        works.append(pg.send([send], d, tag))
    for s in src:
        if s == me:
            recv.copy_(send)
            continue
        works.append(pg.recv([recv], s, tag))
    for wk in works:
        wk.wait()
    if src:
        moved = recv.view(x.dtype) if recv.dtype != x.dtype else recv
        if staged or moved.data_ptr() != out.data_ptr():
            out.copy_(moved)
    mesh._record("ppermute", time.perf_counter() - t0,
                 x.numel() * x.element_size() * max(len(dst), len(src)))
    return out


# -- differentiable collectives -------------------------------------------------


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _raw_all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_reduce(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _raw_all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_raw_reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None,
                None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _raw_reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_raw_all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None,
                None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split, concat):
        ctx.mesh, ctx.axis, ctx.split, ctx.concat = mesh, axis, split, concat
        return _raw_all_to_all(x, mesh, axis, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_raw_all_to_all(g, ctx.mesh, ctx.axis, ctx.concat, ctx.split),
                None, None, None, None)


class _AllToAllV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, in_splits, out_splits):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.in_splits, ctx.out_splits = in_splits, out_splits
        return _raw_all_to_all_v(x, mesh, axis, in_splits, out_splits)

    @staticmethod
    def backward(ctx, g):
        return (_raw_all_to_all_v(g, ctx.mesh, ctx.axis, ctx.out_splits,
                                  ctx.in_splits), None, None, None, None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        tag = mesh._next_tag(axis)
        ctx.mesh, ctx.axis, ctx.perm, ctx.tag = mesh, axis, perm, tag
        return _raw_ppermute(x, mesh, axis, perm, 2 * tag)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return (_raw_ppermute(g, ctx.mesh, ctx.axis, inverse, 2 * ctx.tag + 1),
                None, None, None)


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``lax.psum`` over ``axis`` (16-bit floats summed in f32, rounded
    once). Backward: the all-reduce of the cotangents."""
    return _AllReduce.apply(x, mesh, axis) if mesh.has_axis(axis) else x


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim`` in axis order
    (``lax.all_gather(..., tiled=True)``). Backward: reduce-scatter."""
    return _AllGather.apply(x, mesh, axis, dim) if mesh.has_axis(axis) else x


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The sum over ``axis``, of which this rank keeps block ``axis_index``
    along ``dim`` (``lax.psum_scatter(..., tiled=True)``). Backward:
    all-gather."""
    return (_ReduceScatter.apply(x, mesh, axis, dim) if mesh.has_axis(axis)
            else x)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: ``x`` split along
    ``split_axis`` into one chunk per rank, chunk ``i`` sent to rank
    ``i``, the received chunks concatenated along ``concat_axis`` in rank
    order. Backward: the inverse all-to-all."""
    if not mesh.has_axis(axis):
        return x
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


def all_to_all_v(x: torch.Tensor, mesh: Mesh, axis: str,
                 in_splits: Sequence[int], out_splits: Sequence[int]) -> torch.Tensor:
    """An all-to-all of uneven row counts along dimension 0 (the rows
    for rank ``i`` are the ``i``-th run of ``in_splits``; received runs
    land in rank order). Backward: the reverse move."""
    if not mesh.has_axis(axis):
        return x
    return _AllToAllV.apply(x, mesh, axis, tuple(in_splits), tuple(out_splits))


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: ``perm`` lists ``(source, destination)`` axis
    indices; a rank that is no destination gets zeros. Every rank of the
    axis must make the same calls in the same order (the calls are
    tagged by their order). Backward: the inverse permutation."""
    return _PPermute.apply(x, mesh, axis, tuple((int(s), int(d)) for s, d in perm))


# -- trees and rules ------------------------------------------------------------


def _spec_axes(entry: Any) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a leaf's spec splits it over."""
    return tuple(a for entry in spec for a in _spec_axes(entry))


def _map_with_rules(fn: Callable[[Any, Spec], Any], tree: Any, rules: Any) -> Any:
    """``fn(leaf, spec)`` over ``tree``, reading each leaf's spec at the
    same place in ``rules`` (whose leaves are spec tuples)."""
    if isinstance(tree, dict):
        return {k: _map_with_rules(fn, tree[k], rules[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        if len(rules) != len(tree):
            raise ValueError("rules do not match the tree's structure")
        return type(tree)(_map_with_rules(fn, t, r) for t, r in zip(tree, rules))
    if tree is None:
        return None
    return fn(tree, tuple(rules))


def block_of(leaf: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a whole leaf under ``spec`` (a view)."""
    if len(spec) > leaf.dim():
        raise ValueError(f"spec {spec} has more entries than a leaf of "
                         f"shape {tuple(leaf.shape)}")
    out = leaf
    for dim, entry in enumerate(spec):
        axes = _spec_axes(entry)
        if not axes:
            continue
        for a in axes:
            if a not in mesh.shape:
                raise ValueError(f"spec {spec} names axis {a!r}, not in the "
                                 f"mesh {mesh.shape}")
        n = int(np.prod([mesh.shape[a] for a in axes]))
        idx = 0
        for a in axes:  # the first axis outermost, as a PartitionSpec
            idx = idx * mesh.shape[a] + mesh.coords[a]
        L = leaf.shape[dim]
        if L % n:
            raise ValueError(
                f"dimension {dim} of size {L} not divisible by "
                f"{'x'.join(axes)}={n}")
        out = out.narrow(dim, idx * (L // n), L // n)
    return out


def restrict_rules(rules: Any, mesh: Mesh) -> Any:
    """``rules`` with every axis the mesh lacks dropped (that dimension
    replicated): a model's full rule tree on a mesh of fewer axes."""
    def keep(entry: Any) -> Any:
        axes = tuple(a for a in _spec_axes(entry) if a in mesh.shape)
        if not axes:
            return None
        return axes[0] if isinstance(entry, str) or len(axes) == 1 else axes

    def rec(r: Any) -> Any:
        if isinstance(r, dict):
            return {k: rec(v) for k, v in r.items()}
        if isinstance(r, list):
            return [rec(v) for v in r]
        return tuple(keep(e) for e in r)

    return rec(rules)


def shard_pytree(tree: Any, rules: Any, mesh: Mesh) -> Any:
    """This rank's block of every leaf of a whole tree under ``rules`` (a
    matching tree of spec tuples; see
    ``models.transformer.param_sharding_rules``), as fresh contiguous
    tensors on the leaves' devices: the counterpart of the JAX arrays'
    ``addressable_shards`` on this rank's device."""
    return _map_with_rules(
        lambda leaf, spec: block_of(leaf, spec, mesh).clone(
            memory_format=torch.contiguous_format), tree, rules)


def replicate_pytree(tree: Any, mesh: Mesh) -> Any:
    """Every rank keeps the whole tree (fresh copies)."""
    leaves, treedef = flatten(tree)
    return unflatten(treedef, [l.clone() for l in leaves])


def _batch_block(batch: Any, spec: Spec, mesh: Mesh) -> Any:
    leaves, treedef = flatten(batch)
    return unflatten(treedef, [block_of(l, spec, mesh) for l in leaves])


def reduce_grads(grads: Any, rules: Any, mesh: Mesh) -> Any:
    """Sums each leaf's gradient over every mesh axis its spec does not
    split it over (one coalesced all-reduce per axis); no autograd."""
    leaves, treedef = flatten(grads)
    specs, _ = flatten(_map_with_rules(lambda l, s: _SpecBox(s), grads, rules))
    leaves = list(leaves)
    for axis in mesh.axis_names:
        if not mesh.has_axis(axis):
            continue
        idx = [i for i, s in enumerate(specs) if axis not in spec_axes(s.spec)]
        for dt in sorted({leaves[i].dtype for i in idx}, key=str):
            sel = [i for i in idx if leaves[i].dtype == dt]
            flat = torch.cat([leaves[i].reshape(-1) for i in sel])
            flat = _raw_all_reduce(flat, mesh, axis)
            at = 0
            for i in sel:
                n = leaves[i].numel()
                leaves[i] = flat[at:at + n].view(leaves[i].shape)
                at += n
    return unflatten(treedef, leaves)


class _SpecBox:
    """A spec carried as a leaf (tuples are tree nodes to ``flatten``)."""

    __slots__ = ("spec",)

    def __init__(self, spec: Spec) -> None:
        self.spec = spec


def build_grad_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    mesh: Mesh,
    param_rules: Any,
    batch_spec: Optional[Spec] = None,
) -> Callable[[Any, Any], Tuple[torch.Tensor, Any]]:
    """``step(params, batch) -> (loss, grads)`` on this rank.

    ``params`` are this rank's blocks (:func:`shard_pytree` under
    ``param_rules``); ``batch`` is the whole batch, of which the step
    takes this rank's block under ``batch_spec`` (default ``("data",)``
    when the mesh has a ``data`` axis, else the whole batch). ``loss_fn
    (params, batch)`` returns the rank's scalar mean loss. The returned
    loss is the mean over the mesh and the gradients are those of the
    global mean loss, each leaf's in its own block (summed over the axes
    it is not split over: the psum GSPMD inserts); fresh tensors, so a
    pipelined caller may hold one step's while computing the next."""
    if batch_spec is None:
        batch_spec = ("data",) if "data" in mesh.shape else ()
    seed = 1.0 / mesh.size

    def step(params: Any, batch: Any) -> Tuple[torch.Tensor, Any]:
        leaves, treedef = flatten(params)
        work = [l.detach().requires_grad_(True) for l in leaves]
        local = _batch_block(batch, tuple(batch_spec), mesh)
        loss = loss_fn(unflatten(treedef, work), local)
        grads = torch.autograd.grad(loss * seed, work, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for g, w in zip(grads, work)]
        with torch.no_grad():
            total = loss.detach().float() * seed
            for axis in mesh.axis_names:
                total = _raw_all_reduce(total, mesh, axis)
        return total, reduce_grads(unflatten(treedef, grads), param_rules, mesh)

    return step


def build_apply_step(tx: Any) -> Callable[[Any, Any, Any], Tuple[Any, Any]]:
    """``apply(params, opt_state, grads) -> (params, opt_state)``: the
    optimizer update on this rank's blocks, in place (a block's update is
    the whole leaf's update restricted to it: the optimizers are
    elementwise)."""

    def apply(params: Any, opt_state: Any, grads: Any) -> Tuple[Any, Any]:
        tx.update_(params, opt_state, grads)
        return params, opt_state

    return apply


def run_thread_mesh(
    axis_sizes: Mapping[str, int],
    fn: Callable[[Mesh], Any],
    timeout: float = 300.0,
) -> List[Any]:
    """Runs ``fn(mesh)`` on every rank of a mesh whose ranks are threads
    of this process over one ``HashStore`` (gloo groups), and returns the
    results by rank; the first rank's exception is re-raised. For the
    CPU: each thread is a rank, as each process is on the card."""
    import torch.distributed as dist

    world = int(np.prod(list(axis_sizes.values())))
    store = dist.HashStore()
    results: List[Any] = [None] * world
    errors: List[Optional[BaseException]] = [None] * world

    def run(rank: int) -> None:
        mesh = None
        try:
            mesh = make_mesh(axis_sizes, rank=rank, world_size=world,
                             store=store, timeout=timedelta(seconds=timeout))
            results[rank] = fn(mesh)
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            errors[rank] = e
        finally:
            if mesh is not None:
                mesh.shutdown()

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"mesh {dict(axis_sizes)} ranks still running "
                           f"after {timeout} s")
    for e in errors:
        if e is not None:
            raise e
    return results


def cross_group_average(manager: Any, grads: Any) -> Any:
    """Blocking cross-replica-group gradient average through the manager's
    fault-tolerant collectives (this rank's shard, its own ring)."""
    return manager.allreduce(grads).wait()


__all__ = [
    "Mesh",
    "all_gather",
    "all_reduce",
    "all_to_all",
    "all_to_all_v",
    "block_of",
    "build_apply_step",
    "build_grad_step",
    "build_shard_apply_step",
    "cross_group_average",
    "make_mesh",
    "ppermute",
    "reduce_grads",
    "reduce_scatter",
    "replicate_pytree",
    "restrict_rules",
    "run_thread_mesh",
    "send_recv",
    "shard_pytree",
    "spec_axes",
]

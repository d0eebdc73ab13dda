"""Cross-replica-group collectives over a torch process group rebuilt at
every quorum.

The port of ``torchft_tpu/xla_collectives.py``, the second of the two
cross-group data planes:

- :class:`~.collectives.HostCollectives` (the default): the native TCP
  ring, outside any collective library. Elastic: a reconfigure is a
  millisecond socket rendezvous and a dead peer is an abortable socket
  error.
- :class:`XLACollectives` (this module): the reduction runs in a torch
  process group (``ProcessGroupNCCL`` on the card, ``ProcessGroupGloo``
  on the host), the role of the JAX package's jitted psum over a global
  mesh and of the reference's NCCL backend choice. The group is built
  directly on a ``PrefixStore``, never through ``init_process_group``:
  the default group is process-global and cannot be rebuilt per quorum.

Rendezvous: rank 0 opens a ``TCPStore`` on port 0 and publishes
``host:port`` through the native store under ``<prefix>/xla_coordinator``
(the quorum's prefix), the other ranks read it and connect. The listener
exists before the address is published, so the port race the JAX
package's retried coordinator reservation guards against cannot happen
here.

``configure()`` onto a new membership drops the old group and builds a
new one. Unlike ``jax.distributed.shutdown``, that orphans no tensor:
the group owns none, so :meth:`XLACollectives.register_state` keeps the
JAX package's API but no holder needs a host round trip. A peer that
dies mid-collective can still hold the op until the group's timeout (an
in-flight collective cannot be interrupted): ``configure()`` then fails
fast with ``TimeoutError`` after its bounded wait, as in the JAX
package. Use it for static memberships where cross-group bandwidth
dominates; the host ring stays the default for elastic ones, and
:mod:`.isolated_xla` puts this plane in a disposable child.

``backend=None`` picks ``"nccl"`` when CUDA is available, else
``"gloo"`` (the counterpart of the JAX child's platform pin). An
explicit ``"nccl"`` that cannot initialise raises; it never becomes
gloo. NCCL reduces card tensors where they are; gloo reduces host
buffers, so card leaves cross to the host and back (``d2h_bytes``).
Results come back on the input leaves' devices, in their dtypes, as the
host ring returns them.
"""

from __future__ import annotations

import socket
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ._native import StoreClient
from ._tree import flatten as _flatten
from ._tree import unflatten as _unflatten
from .collectives import (
    Collectives,
    OpStatsMixin,
    ReduceOp,
    Work,
    _caller_event,
    _divide_,
    _identity,
)

_COORD_KEY = "xla_coordinator"

_BACKENDS = ("gloo", "nccl")


def _split_store_addr(store_addr: str) -> Tuple[str, str]:
    """``host:port/prefix`` -> (``host:port``, ``prefix``)."""
    hostport, _, prefix = store_addr.partition("/")
    return hostport, prefix


def _coord_key(prefix: str) -> str:
    return f"{prefix}/{_COORD_KEY}" if prefix else _COORD_KEY


def _resolve_backend(backend: Optional[str]) -> str:
    if backend is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    if backend not in _BACKENDS:
        raise ValueError(f"unsupported backend: {backend!r} (want gloo|nccl)")
    return backend


def _torch_op(op: ReduceOp) -> Any:
    import torch.distributed as dist

    return {
        ReduceOp.SUM: dist.ReduceOp.SUM,
        ReduceOp.AVG: dist.ReduceOp.SUM,  # then the divide
        ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
        ReduceOp.MIN: dist.ReduceOp.MIN,
        ReduceOp.MAX: dist.ReduceOp.MAX,
    }[op]


def _rendezvous(store: StoreClient, prefix: str, rank: int, world_size: int,
                connect_timeout: timedelta) -> Any:
    """The quorum's ``TCPStore``: rank 0 opens it on port 0 and publishes
    the bound ``host:port`` under the coordinator key; other ranks read
    the key and connect."""
    import torch.distributed as dist

    key = _coord_key(prefix)
    if rank == 0:
        host = socket.gethostname()
        tcp = dist.TCPStore(host, 0, world_size, True,
                            timeout=connect_timeout, wait_for_workers=False)
        store.set(key, f"{host}:{tcp.port}".encode(), timeout=connect_timeout)
        return tcp
    coord = store.get(key, timeout=connect_timeout).decode()
    host, _, port = coord.rpartition(":")
    return dist.TCPStore(host, int(port), world_size, False,
                         timeout=connect_timeout)


def _groups_of(leaves: Sequence[torch.Tensor]
               ) -> List[Tuple[torch.dtype, List[int]]]:
    """Leaf indices by exact dtype, in first-appearance order: each group
    reduces as one flat buffer in its own dtype, as the JAX package
    reduces each leaf in its own."""
    groups: List[Tuple[torch.dtype, List[int]]] = []
    for i, l in enumerate(leaves):
        for dt, idxs in groups:
            if dt == l.dtype:
                idxs.append(i)
                break
        else:
            groups.append((l.dtype, [i]))
    return groups


def _nbytes(leaves: Sequence[torch.Tensor]) -> int:
    return sum(l.numel() * l.element_size() for l in leaves)


class XLACollectives(OpStatsMixin, Collectives):
    """Reconfigurable cross-group collectives in a torch process group
    built per quorum (module docstring). Every op packs the tree into one
    flat buffer per dtype and runs one collective per buffer; results
    land on the input leaves' devices."""

    def __init__(
        self,
        timeout: timedelta = timedelta(seconds=60),
        connect_timeout: timedelta = timedelta(seconds=60),
        backend: Optional[str] = None,
    ) -> None:
        """There is no ``keep_global``: results always land on the input
        leaves' devices (the JAX package's switch chose between host and
        mesh-resident results), and :meth:`global_mesh` returns the live
        process group."""
        self._timeout = timeout
        self._connect_timeout = connect_timeout
        self._backend = _resolve_backend(backend)
        self._rank = -1
        self._world_size = 0
        self._pg: Any = None
        self._tcp: Any = None
        # One thread: collectives must issue in submission order.
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="xla_collectives")
        self._shutdown_flag = False
        self._aborted = False
        self._protected: List[Any] = []

    @property
    def backend(self) -> str:
        return self._backend

    def register_state(self, state: Any) -> None:
        """The JAX package's hook for holders to round-trip through the
        host across a reconfigure. Rebuilding a torch process group
        orphans no tensor, so the holders are only recorded."""
        self._protected.append(state)

    # -- lifecycle --

    def abort(self) -> None:
        """Fails queued-but-unstarted ops fast. An in-flight collective is
        not interrupted: it ends at the group's timeout."""
        self._aborted = True

    def configure(
        self,
        store_addr: str,
        rank: int,
        world_size: int,
        regions: Optional[Sequence[str]] = None,
        hosts: Optional[Sequence[str]] = None,
    ) -> None:
        """Builds the process group of the new membership on a fresh
        ``TCPStore`` (``regions``/``hosts`` are accepted and ignored: the
        library owns placement). A solo world builds no group; its ops
        are local."""
        self._aborted = True

        def do_configure() -> None:
            self._teardown()
            if world_size > 1:
                import torch.distributed as dist

                hostport, prefix = _split_store_addr(store_addr)
                store = StoreClient(hostport,
                                    connect_timeout=self._connect_timeout)
                tcp = _rendezvous(store, prefix, rank, world_size,
                                  self._connect_timeout)
                self._tcp = tcp
                self._pg = self._new_group(dist.PrefixStore("pg", tcp), rank,
                                           world_size)
            self._rank = rank
            self._world_size = world_size
            self._aborted = False

        # Bounded wait: an op wedged on a dead peer holds the op thread
        # until the group's timeout; the caller gets a TimeoutError to
        # latch instead of a hang.
        budget = (self._connect_timeout.total_seconds()
                  + self._timeout.total_seconds())
        self._executor.submit(do_configure).result(timeout=budget)

    def _new_group(self, store: Any, rank: int, world_size: int) -> Any:
        import torch.distributed as dist

        if self._backend == "gloo":
            return dist.ProcessGroupGloo(store, rank, world_size, self._timeout)
        if not (dist.is_nccl_available() and torch.cuda.is_available()):
            raise RuntimeError("backend='nccl' needs CUDA and a torch build "
                               "with NCCL")
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = self._timeout
        pg = dist.ProcessGroupNCCL(store, rank, world_size, opts)
        # The communicator initialises lazily: run one collective here so a
        # refusal raises from configure, not from the first step.
        probe = torch.zeros(1, device=self._nccl_device())
        pg.allreduce([probe]).wait()
        torch.cuda.synchronize(probe.device)
        return pg

    @staticmethod
    def _nccl_device() -> torch.device:
        return torch.device("cuda", torch.cuda.current_device())

    def _teardown(self) -> None:
        pg, self._pg, self._tcp = self._pg, None, None
        if pg is not None:
            try:
                pg.shutdown()
            except Exception:  # noqa: BLE001 - a torn group is gone either way
                pass

    def global_mesh(self) -> Any:
        """The live process group (None in a solo world): the object to
        run further collectives of this membership on."""
        assert self._world_size > 0, "configure() first"
        return self._pg

    def shutdown(self) -> None:
        if self._shutdown_flag:
            return
        self._shutdown_flag = True
        # Same bounded wait as configure(): a wedged op must not hang
        # process teardown; on timeout the op thread is left behind.
        try:
            self._executor.submit(self._teardown).result(
                timeout=self._timeout.total_seconds())
            self._executor.shutdown(wait=True)
        except FuturesTimeoutError:
            self._executor.shutdown(wait=False)

    def size(self) -> int:
        return self._world_size

    def rank(self) -> int:
        return self._rank

    # -- packing --

    def _submit(self, fn: Callable[[], Any]) -> Work:
        if self._shutdown_flag:
            raise RuntimeError("collectives already shut down")

        def guarded() -> Any:
            if self._aborted:
                raise RuntimeError("collectives aborted")
            return fn()

        return Work(self._executor.submit(guarded))

    def _wire_device(self, leaves: Sequence[torch.Tensor]) -> torch.device:
        if self._backend == "nccl":
            card = [l for l in leaves if l.is_cuda]
            return card[0].device if card else self._nccl_device()
        return torch.device("cpu")

    def _pack(self, leaves: Sequence[torch.Tensor],
              caller: Optional[Tuple[Any, Any]]
              ) -> Tuple[List[Tuple[torch.dtype, List[int]]],
                         List[torch.Tensor], bool]:
        """One fresh flat buffer per dtype group on the wire device, and
        whether card bytes crossed to the host for it."""
        wire = self._wire_device(leaves)
        groups = _groups_of(leaves)
        if caller is not None:
            caller[1].synchronize()
        bufs = []
        for _, idxs in groups:
            parts = [leaves[i].detach().reshape(-1) for i in idxs]
            if len({p.device for p in parts}) > 1:
                parts = [p.to(wire) for p in parts]
            # cat copies even one part: the collective reduces in place
            bufs.append(torch.cat(parts).to(wire))
        crossed = wire.type == "cpu" and any(l.is_cuda for l in leaves)
        return groups, bufs, crossed

    @staticmethod
    def _unpack(groups: List[Tuple[torch.dtype, List[int]]],
                bufs: Sequence[torch.Tensor], leaves: Sequence[torch.Tensor],
                treedef: Any) -> Any:
        """Leaves as views of the group buffers, each on its input
        leaf's device (one copy per group and device)."""
        out: List[Optional[torch.Tensor]] = [None] * len(leaves)
        for (_, idxs), buf in zip(groups, bufs):
            moved = {}
            off = 0
            for i in idxs:
                dev = leaves[i].device
                if dev not in moved:
                    moved[dev] = buf if buf.device == dev else buf.to(dev)
                n = leaves[i].numel()
                out[i] = moved[dev][off:off + n].view(leaves[i].shape)
                off += n
        return _unflatten(treedef, out)

    @staticmethod
    def _divide_buf(buf: torch.Tensor, divisor: float) -> None:
        if buf.is_cuda and buf.dtype in (torch.float32, torch.float64):
            # a same-device 0-d divisor: a CPU scalar may become a
            # reciprocal multiply on the card, which rounds differently
            buf.div_(torch.full((), divisor, dtype=buf.dtype,
                                device=buf.device))
        else:
            _divide_(buf, divisor)

    # -- flat in-place ops (the isolated child's entry points) --

    def _reduce_flat_(self, bufs: Sequence[torch.Tensor], op: ReduceOp,
                      divisor: Optional[float] = None) -> Work:
        """Reduces flat wire-device buffers in place (the isolated
        child's mapped segment views): no pack, no copy back."""

        def run() -> None:
            if op == ReduceOp.AVG:
                div: Optional[float] = float(self._world_size)
            else:
                div = divisor
            for buf in bufs:
                if self._world_size > 1 and buf.numel():
                    self._allreduce_buf(buf, op)
                if div is not None and div != 1:
                    self._divide_buf(buf, div)

        return self._submit(run)

    def _allgather_flat(self, inp: torch.Tensor,
                        outs: Sequence[torch.Tensor]) -> Work:
        """Gathers ``inp`` of every rank into ``outs`` (rank order)."""

        def run() -> None:
            if self._world_size == 1:
                outs[0].copy_(inp)
            elif inp.numel():
                self._pg.allgather([list(outs)], [inp]).wait()

        return self._submit(run)

    def _broadcast_flat_(self, buf: torch.Tensor, root: int) -> Work:
        def run() -> None:
            if self._world_size > 1 and buf.numel():
                self._pg.broadcast(buf, root).wait()

        return self._submit(run)

    def _allreduce_buf(self, buf: torch.Tensor, op: ReduceOp) -> None:
        import torch.distributed as dist

        opts = dist.AllreduceOptions()
        opts.reduceOp = _torch_op(op)
        self._pg.allreduce([buf], opts).wait()

    # -- ops --

    def allreduce(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.SUM,
        divisor: Optional[float] = None,
        wire: Optional[str] = None,
    ) -> Work:
        # wire="q8" is accepted and served losslessly: the quantized wire
        # exists for the host ring's TCP links, and the library's f32
        # reduction is this plane's native path.
        caller = _caller_event(tree)
        return self._submit(
            lambda: self._allreduce_sync(tree, op, divisor, caller))

    def _allreduce_sync(self, tree: Any, op: ReduceOp,
                        divisor: Optional[float] = None,
                        caller: Optional[Tuple[Any, Any]] = None) -> Any:
        if divisor is not None and op != ReduceOp.SUM:
            raise ValueError("divisor only composes with ReduceOp.SUM")
        leaves, treedef = _flatten(tree)
        if op == ReduceOp.AVG:
            divisor = float(self._world_size)
        if self._world_size == 1 or not leaves:
            return _identity(tree, leaves, treedef, divisor)
        t0 = time.perf_counter()
        groups, bufs, crossed = self._pack(leaves, caller)
        t1 = time.perf_counter()
        for buf in bufs:
            if buf.numel():
                self._allreduce_buf(buf, op)
            if divisor is not None and divisor != 1:
                self._divide_buf(buf, divisor)
        if bufs and bufs[0].is_cuda:
            torch.cuda.synchronize(bufs[0].device)
        t2 = time.perf_counter()
        out = self._unpack(groups, bufs, leaves, treedef)
        nbytes = _nbytes(leaves)
        # the JAX package's keys: payload bytes, the bytes that crossed
        # the card link, and the pack / collective / return split
        self._record_op_stats({
            "op": "allreduce",
            "backend": "xla",
            "bytes": nbytes,
            "d2h_bytes": nbytes if crossed else 0,
            "pack": t1 - t0,
            "ring": t2 - t1,
            "h2d": time.perf_counter() - t2,
        })
        return out

    def allgather(self, tree: Any) -> Work:
        caller = _caller_event(tree)
        return self._submit(lambda: self._allgather_sync(tree, caller))

    def _allgather_sync(self, tree: Any,
                        caller: Optional[Tuple[Any, Any]]) -> List[Any]:
        if self._world_size == 1:
            return [tree]
        leaves, treedef = _flatten(tree)
        if not leaves:
            return [tree] * self._world_size
        t0 = time.perf_counter()
        groups, bufs, crossed = self._pack(leaves, caller)
        world = self._world_size
        rows = []
        for buf in bufs:
            full = torch.empty((world, buf.numel()), dtype=buf.dtype,
                               device=buf.device)
            if buf.numel():
                self._pg.allgather([list(full.unbind(0))], [buf]).wait()
            rows.append(full)
        if bufs and bufs[0].is_cuda:
            torch.cuda.synchronize(bufs[0].device)
        t1 = time.perf_counter()
        out = [self._unpack(groups, [full[r] for full in rows], leaves,
                            treedef) for r in range(world)]
        nbytes = _nbytes(leaves)
        self._record_op_stats({
            "op": "allgather",
            "backend": "xla",
            "bytes": nbytes,
            "d2h_bytes": nbytes if crossed else 0,
            "pack": t1 - t0,
            "h2d": time.perf_counter() - t1,
        })
        return out

    def broadcast(self, tree: Any, root: int = 0) -> Work:
        caller = _caller_event(tree)
        return self._submit(lambda: self._broadcast_sync(tree, root, caller))

    def _broadcast_sync(self, tree: Any, root: int,
                        caller: Optional[Tuple[Any, Any]]) -> Any:
        if self._world_size == 1:
            if root != 0:
                raise RuntimeError(f"bad broadcast root {root} for world size 1")
            return tree
        leaves, treedef = _flatten(tree)
        if not leaves:
            return tree
        groups, bufs, crossed = self._pack(leaves, caller)
        t0 = time.perf_counter()
        for buf in bufs:
            if buf.numel():
                self._pg.broadcast(buf, root).wait()
        out = self._unpack(groups, bufs, leaves, treedef)
        nbytes = _nbytes(leaves)
        self._record_op_stats({
            "op": "broadcast",
            "backend": "xla",
            "bytes": nbytes,
            "d2h_bytes": nbytes if crossed else 0,
            "h2d": time.perf_counter() - t0,
        })
        return out

    def barrier(self) -> Work:
        return self._submit(lambda: self._allreduce_sync(
            torch.zeros((1,), dtype=torch.float32), ReduceOp.SUM))

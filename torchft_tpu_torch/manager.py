"""Fault-tolerant training-step state machine.

The port of ``torchft_tpu/manager.py``, cut to the per-step transaction.
Every training step is a transaction:

- ``start_quorum()`` establishes membership asynchronously, overlapped
  with the forward/backward (quorum RPCs ride a one-thread executor while
  the card computes); ``use_async_quorum=False`` waits for it instead,
  and a healing member applies the fetched state there and takes part
  in the same step (what the DiLoCo family requires).
- ``allreduce()`` / ``plan_allreduce()`` average gradient trees across
  replica groups through the reconfigurable host collectives
  (``allgather()`` gathers them; ``plan_reduce_scatter()`` /
  ``plan_allgather_into()`` are the two legs of per-step ZeRO); errors
  are latched, never raised into the train loop, so the step is
  discarded by the commit vote. ``reduce_scatter()`` /
  ``allgather_into()`` are the bulk split legs of the sharded outer
  sync.
- ``should_commit()`` is a distributed AND-vote: if any rank of any group
  saw an error, every group discards the step.
- A recovering replica fetches live weights from a healthy peer over HTTP
  (:mod:`.checkpointing`'s streamed heal, onto the group's device)
  instead of restarting the world.

Topology: each group carries a region and a host label (``TORCHFT_REGION``
/ ``TORCHFT_HOST``, the host label defaulting to the hostname); the
quorum's maps ride into ``configure``, so co-hosted groups reduce over
the shared-memory host tier under ``plan_allreduce(hier=True)`` /
``allreduce_hier``. Observability: ``observe_op_stats`` drains the data
plane's per-op stats into the rolling wire and per-tier throughput that
``signals()`` reports and ``push_status`` publishes to the lighthouse.

A "replica group" is one GPU (or one host's GPUs); intra-group
parallelism is invisible to this class. Commit hooks
(:meth:`Manager.add_commit_hook`) observe every vote, which is where the
durable tier captures and the serving plane publishes; a cold fleet's
first quorum consults the durable tier (``durable_restore``). The
isolated data plane of the JAX Manager is not ported.
"""

from __future__ import annotations

import inspect
import logging
import os
import socket
import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from datetime import timedelta
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, TypeVar, Union, cast

import torch

from . import _native
from ._device import resolve_device
from ._native import ManagerClient, StoreClient
from ._tree import tree_map
from .checkpointing import CheckpointServer, CheckpointTransport
from .collectives import Collectives, ReduceOp, Work, _completed
from .futures import work_timeout
from .metrics import Metrics
from .profiling import Profiler, span

logger: logging.Logger = logging.getLogger(__name__)

MANAGER_ADDR_KEY: str = "manager_addr"
REPLICA_ID_KEY: str = "replica_id"
T = TypeVar("T")


class WorldSizeMode(Enum):
    """How the effective world size behaves under faults: ``DYNAMIC``
    averages over whoever takes part; ``FIXED_WITH_SPARES`` keeps the
    divisor at ``min_replica_size``, and the groups ranked past it join
    the collectives as spares with zeroed gradients."""

    DYNAMIC = 0
    FIXED_WITH_SPARES = 1


def _zero_leaf(leaf: Any) -> Any:
    return leaf * 0 if isinstance(leaf, torch.Tensor) else leaf


class Manager:
    """Fault tolerance manager for one rank of one replica group.

    Typically composed with :class:`~torchft_tpu_torch.optim.OptimizerWrapper`
    and a gradient-averaging wrapper so the train loop stays
    ``zero_grad(); grads; step()``-shaped.
    """

    def __init__(
        self,
        collectives: Collectives,
        load_state_dict: Optional[Callable[[T], None]],
        state_dict: Optional[Callable[[], T]],
        min_replica_size: int,
        timeout: timedelta = timedelta(seconds=60),
        quorum_timeout: timedelta = timedelta(seconds=60),
        connect_timeout: timedelta = timedelta(seconds=20),
        rank: Optional[int] = None,
        world_size: Optional[int] = None,
        world_size_mode: WorldSizeMode = WorldSizeMode.DYNAMIC,
        store_addr: Optional[str] = None,
        lighthouse_addr: Optional[str] = None,
        lighthouse_root_addr: Optional[str] = None,
        region_probe_max: Optional[int] = None,
        lease_ttl: Optional[timedelta] = None,
        replica_id: Optional[str] = None,
        hostname: str = socket.gethostname(),
        heartbeat_interval: timedelta = timedelta(milliseconds=100),
        region: Optional[str] = None,
        host_label: Optional[str] = None,
        device: Optional[Union[str, torch.device]] = None,
        use_async_quorum: bool = True,
        checkpoint_transport: Optional[CheckpointTransport[Dict[str, T]]] = None,
        profiler: Optional[Profiler] = None,
        durable_restore: Optional[Callable[[], Optional[int]]] = None,
    ) -> None:
        """
        Args:
            collectives: the reconfigurable cross-replica-group collectives.
            load_state_dict: restores USER state from a recovery checkpoint
                (tensors on ``device`` from the streamed heal, numpy leaves
                from its pickled fallbacks; copy them into the live state).
            state_dict: captures USER state for recovery transfer.
            min_replica_size: minimum replica groups for a committable step.
            rank / world_size: this rank within the replica group (env
                ``RANK``/``WORLD_SIZE`` when None).
            world_size_mode: ``FIXED_WITH_SPARES`` fixes the divisor at
                ``min_replica_size`` (clamped down, so a short cohort
                still fails the vote) and zeroes the gradients of the
                groups ranked past it (the launcher's hot spares).
            store_addr: ``host:port`` of the group's rendezvous Store (env
                ``MASTER_ADDR``+``MASTER_PORT``; with neither and
                world_size == 1, an in-process Store is created).
            lighthouse_addr: the group's lighthouse (env
                ``TORCHFT_LIGHTHOUSE``): the flat or root service, or the
                group's region lighthouse under a hierarchical tier.
            lighthouse_root_addr: the root fallback (env
                ``TORCHFT_LIGHTHOUSE_ROOT``): a dead region demotes the
                group to the root until it returns. Either address may
                be a comma-separated failover set (the active root and
                its warm standbys); renewals rotate on failure.
            region_probe_max: how many failed region re-probes a demoted
                manager makes before it stays on the root (env
                ``TORCHFT_REGION_PROBE_MAX``, default 20; 0 = forever).
            lease_ttl: the membership lease (env ``TORCHFT_LEASE_TTL_MS``;
                None = the lighthouse's heartbeat timeout).
            replica_id: replica group name; group rank 0 appends a uuid.
            hostname: the name peers reach this group's manager by.
            heartbeat_interval: the native manager's renewal interval.
            region: this group's region label (env ``TORCHFT_REGION``,
                else unlabeled).
            host_label: this group's host label (env ``TORCHFT_HOST``,
                else the hostname). Groups sharing a (region, host) pair
                reduce over the shared-memory host tier on the two-tier
                schedule.
            device: where this group's state lives: a streamed heal
                uploads there, and a publish to a healing peer is ordered
                after the work the training thread had queued on it
                (``None``: the card).
            use_async_quorum: overlap the quorum with the
                forward/backward (a healing member sits its step out);
                False waits for it in ``start_quorum``, where a healing
                member applies the fetched state and then takes part in
                the step like any other.
            checkpoint_transport: the live-recovery transport (default:
                a :class:`~.checkpointing.CheckpointServer` on ``device``).
            profiler: a windowed ``torch.profiler`` capture (default: one
                from the ``TORCHFT_PROFILE_*`` variables, or none).
            durable_restore: the durable tier's cold-start fallback
                (``DurableCheckpointer.restore_latest``; its constructor
                registers it through :meth:`set_durable_restore`). It is
                consulted once, at the first quorum, and only when no
                member has committed a step (``max_step == 0``) and this
                one is at step 0: a live donor always wins over the
                durable tier.
        """
        self._load_state_dict = load_state_dict
        self._user_state_dict = state_dict
        self._min_replica_size = min_replica_size
        self._timeout = timeout
        self._use_async_quorum = use_async_quorum
        self._quorum_timeout = quorum_timeout
        self._connect_timeout = connect_timeout
        self._world_size_mode = world_size_mode

        self._rank: int = rank if rank is not None else int(os.environ.get("RANK", 0))
        self._world_size: int = (
            world_size
            if world_size is not None
            else int(os.environ.get("WORLD_SIZE", 1))
        )

        self._owned_store: Optional[_native.Store] = None
        if store_addr is None:
            if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
                store_addr = (
                    f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
                )
            elif self._world_size == 1:
                self._owned_store = _native.Store()
                store_addr = self._owned_store.address()
            else:
                raise ValueError(
                    "store_addr (or MASTER_ADDR/MASTER_PORT) required when "
                    "world_size > 1"
                )
        self._store = StoreClient(store_addr, connect_timeout=connect_timeout)

        self._collectives = collectives
        self._device = resolve_device(device)
        # the training thread's stream at start_quorum: what a publish to
        # a healing peer waits for (card state)
        self._writer_stream: Optional[torch.cuda.Stream] = None
        self._checkpoint_transport: CheckpointTransport[Dict[str, T]] = (
            checkpoint_transport if checkpoint_transport is not None
            else CheckpointServer(timeout=timeout, device=self._device)
        )
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="async_quorum"
        )
        self._quorum_future: Optional[Future] = None

        self._step = 0
        self._batches_committed = 0
        self._quorum_id = -1
        self._errored: Optional[Exception] = None
        self._op_epoch = 0
        # Makes {epoch check -> error latch} in work callbacks atomic
        # against {epoch bump -> error clear} in start_quorum.
        self._error_lock = threading.Lock()
        self._force_reconfigure = False
        self._healing = False
        self._pending_work: List[Work] = []
        self._pending_state_dict: Optional[Dict[str, object]] = None
        self._participating_rank: Optional[int] = None
        self._participating_world_size: int = 0
        self._metrics = Metrics()
        self._profiler = profiler if profiler is not None else Profiler.from_env()
        # observers of every vote: hook(step, quorum_id, committed)
        self._commit_hooks: List[Callable[[int, int, bool], None]] = []
        self._durable_restore = durable_restore
        self._durable_consulted = False
        # signals(): the last measured wire and per-tier throughput
        self._last_wire_eff_mbps: Optional[float] = None
        self._last_tier_mbps: Dict[str, float] = {}
        self._opt_state_bytes: Optional[int] = None

        if region is None:
            region = os.environ.get("TORCHFT_REGION", "")
        if host_label is None:
            host_label = os.environ.get("TORCHFT_HOST", socket.gethostname())
        self._region = region
        # The quorum's region and host maps (replica-rank order),
        # refreshed at every reconfigure.
        self._replica_regions: List[str] = []
        self._replica_hosts: List[str] = []

        lighthouse_addr = lighthouse_addr or os.environ.get("TORCHFT_LIGHTHOUSE")
        lighthouse_root_addr = lighthouse_root_addr or os.environ.get(
            "TORCHFT_LIGHTHOUSE_ROOT", "")
        if region_probe_max is None:
            region_probe_max = int(os.environ.get("TORCHFT_REGION_PROBE_MAX", "20"))
        self._region_probe_max = region_probe_max
        if lease_ttl is None:
            env_ttl = os.environ.get("TORCHFT_LEASE_TTL_MS")
            if env_ttl:
                lease_ttl = timedelta(milliseconds=int(env_ttl))
        replica_id = replica_id if replica_id is not None else ""
        self._manager: Optional[_native.Manager] = None
        if self._rank == 0:
            if lighthouse_addr is None:
                raise ValueError(
                    "lighthouse_addr (or TORCHFT_LIGHTHOUSE) required on rank 0"
                )
            # Group rank 0 hosts the native manager server and publishes its
            # address + the uuid-qualified replica id through the store.
            replica_id = (
                f"{replica_id}:{uuid.uuid4()}" if replica_id else str(uuid.uuid4())
            )
            bind = f"[::]:{int(os.environ.get('TORCHFT_MANAGER_PORT', 0))}"
            self._manager = _native.Manager(
                replica_id=replica_id,
                lighthouse_addr=lighthouse_addr,
                hostname=hostname,
                bind=bind,
                store_addr=store_addr,
                world_size=self._world_size,
                heartbeat_interval=heartbeat_interval,
                connect_timeout=connect_timeout,
                root_addr=lighthouse_root_addr,
                lease_ttl=lease_ttl,
                region=region,
                host=host_label,
                region_probe_max=region_probe_max,
            )
            self._store.set(MANAGER_ADDR_KEY, self._manager.address().encode())
            self._store.set(REPLICA_ID_KEY, replica_id.encode())

        addr = self._store.get(MANAGER_ADDR_KEY, timeout=connect_timeout).decode()
        self._client = ManagerClient(addr, connect_timeout=connect_timeout)
        self._replica_id = self._store.get(
            REPLICA_ID_KEY, timeout=connect_timeout
        ).decode()

    def shutdown(self) -> None:
        if self._profiler is not None:
            self._profiler.shutdown()
        self._checkpoint_transport.shutdown(wait=False)
        self._executor.shutdown(wait=True)
        if self._manager is not None:
            self._manager.shutdown()
        if self._owned_store is not None:
            self._owned_store.shutdown()

    # -- step lifecycle --

    def start_quorum(
        self,
        allow_heal: bool = True,
        shrink_only: bool = False,
        timeout: Optional[timedelta] = None,
    ) -> None:
        """Starts computing a new quorum. Asynchronously by default: it
        overlaps the forward/backward, and a replica that must heal sits
        this step out (its gradients are zeroed; the checkpoint applies
        at the ``should_commit`` safe point). With
        ``use_async_quorum=False`` it waits for the quorum, a healing
        replica applies the fetched state here, and it then takes part
        in this step. ``allow_heal=False`` neither serves nor fetches a
        checkpoint (only members at the max step participate);
        ``shrink_only`` asks the lighthouse for a quorum of the current
        members only. Call at the start of every step, on every rank."""
        if self._profiler is not None:
            self._profiler.on_step(self._step)
        if self._quorum_future is not None:
            # The previous quorum's errors were surfaced through the
            # collectives and the vote; a new step starts clean.
            try:
                self._quorum_future.result()
            except Exception:
                pass

        with self._error_lock:
            self._op_epoch += 1
            self._errored = None
        self._healing = False
        self._pending_work = []
        if self._device.type == "cuda":
            self._writer_stream = torch.cuda.current_stream(self._device)
        self._quorum_future = self._executor.submit(
            self._async_quorum,
            allow_heal=allow_heal,
            shrink_only=shrink_only,
            quorum_timeout=timeout or self._quorum_timeout,
        )
        if not self._use_async_quorum:
            self.wait_quorum()
            if self._healing:
                # Apply the fetched state now, so this step's work starts
                # from it and the healed member takes part in full.
                self._apply_pending_state_dict()
                self._healing = False

    def wait_quorum(self) -> None:
        """Blocks until the quorum started by ``start_quorum`` completes."""
        assert (
            self._quorum_future is not None
        ), "must call start_quorum before wait_quorum"
        self._quorum_future.result()

    def _async_quorum(self, allow_heal: bool, shrink_only: bool,
                      quorum_timeout: timedelta) -> None:
        # Consume the rebuild request atomically; restore it if the RPC
        # fails (the rebuild still hasn't happened).
        with self._error_lock:
            force_reconfigure = self._force_reconfigure
            self._force_reconfigure = False
        try:
            with self._metrics.timed("quorum"), span("torchft::quorum"):
                result = self._client.quorum(
                    rank=self._rank,
                    step=self._step,
                    checkpoint_metadata=self._checkpoint_transport.metadata(),
                    shrink_only=shrink_only,
                    force_reconfigure=force_reconfigure,
                    timeout=quorum_timeout,
                )
        except Exception:
            if force_reconfigure:
                with self._error_lock:
                    self._force_reconfigure = True
            raise

        if self._use_async_quorum or not allow_heal:
            # Healing overlaps this step, so recovering replicas sit it
            # out: only members already at max_step participate.
            self._participating_rank = result.max_rank
            self._participating_world_size = result.max_world_size
        else:
            # The heal completes inside start_quorum: every member takes
            # part.
            self._participating_rank = result.replica_rank
            self._participating_world_size = result.replica_world_size

        if self._world_size_mode == WorldSizeMode.FIXED_WITH_SPARES:
            # Spares take part with zeroed gradients and the divisor
            # stays fixed, so numerics never change under churn; min()
            # keeps a cohort below min_replica_size failing the vote.
            if (self._participating_rank is not None
                    and self._participating_rank >= self._min_replica_size):
                self._participating_rank = None
            self._participating_world_size = min(
                self._participating_world_size, self._min_replica_size)

        if self._durable_restore is not None and not self._durable_consulted:
            # One-shot donor/durable arbitration at the first quorum: a
            # live donor (max_step > 0) is at least as fresh as any
            # committed snapshot and the heal ships it, so the durable
            # tier is consulted only by a cold fleet. Every member
            # restores from the shared store, so the fleet rises at one
            # committed step; a member that finds nothing init-syncs
            # from a restored peer as usual.
            self._durable_consulted = True
            if self._step == 0 and result.max_step == 0:
                restored = self._durable_restore()
                if restored is not None:
                    self._metrics.incr("durable_cold_restores")
                    logger.info(
                        f"[{self._replica_id}/{self._rank}] cold fleet: "
                        f"restored durable step {restored} (no live donor)")

        if result.quorum_id != self._quorum_id:
            if self._quorum_id != -1:
                # Membership moved (or an error forced a rebuild) mid-run:
                # the rolling churn signal. The first configure is a cold
                # start, not churn.
                self._metrics.mark("churn")
            # Reconfigure the data plane on a store prefix unique to this
            # quorum AND this local rank, so stale members can't collide.
            prefix = (
                f"{result.store_address}/torchft/{result.quorum_id}/{self._rank}"
            )
            logger.info(
                f"[{self._replica_id}/{self._rank}] reconfiguring collectives "
                f"quorum_id={result.quorum_id}"
            )
            # The quorum's region and host maps ride into the data plane,
            # which compiles them into the two-tier schedule when usable.
            # The hosts kwarg goes only to a backend that declares it.
            self._replica_regions = list(result.replica_regions)
            self._replica_hosts = list(result.replica_hosts)
            cfg_kwargs: Dict[str, Any] = {
                "regions": self._replica_regions or None}
            if any(self._replica_hosts) and self._configure_takes_hosts():
                cfg_kwargs["hosts"] = self._replica_hosts
            with self._metrics.timed("reconfigure"), span(
                "torchft::reconfigure"
            ):
                self._collectives.configure(
                    prefix, result.replica_rank, result.replica_world_size,
                    **cfg_kwargs,
                )
            self._metrics.incr("reconfigures")
            self._quorum_id = result.quorum_id

        if not allow_heal:
            return
        if result.recover_dst_ranks:
            # This replica is a recovery source: publish live weights.
            with span("torchft::send_checkpoint"):
                self._checkpoint_transport.send_checkpoint(
                    dst_ranks=result.recover_dst_ranks,
                    step=result.max_step,
                    state_dict=self._manager_state_dict(),
                    timeout=self._timeout,
                    stream=self._writer_stream,
                )
        if result.heal:
            self._healing = True
            # max_step 0 is the initial weight sync of a fresh cohort,
            # not a fault.
            self._metrics.incr(
                "heals" if result.max_step > 0 else "init_sync_heals"
            )
            logger.info(
                f"[{self._replica_id}/{self._rank}] healing from "
                f"{result.recover_src_manager_address} "
                f"step={result.max_step}"
            )
            primary_client = ManagerClient(
                result.recover_src_manager_address,
                connect_timeout=self._connect_timeout,
            )
            checkpoint_metadata = primary_client.checkpoint_metadata(
                self._rank, timeout=self._timeout
            )
            assert result.recover_src_rank is not None
            with self._metrics.timed("heal_fetch"), span(
                "torchft::recv_checkpoint"
            ):
                checkpoint = self._checkpoint_transport.recv_checkpoint(
                    src_rank=result.recover_src_rank,
                    metadata=checkpoint_metadata,
                    step=result.max_step,
                    timeout=self._timeout,
                )
            # Manager state applies now (step counters); user state
            # waits for the safe point on the main thread.
            self._pending_state_dict = cast(Dict[str, object], checkpoint)
            self.load_state_dict(cast(Dict[str, int], checkpoint["torchft"]))

    def _apply_pending_state_dict(self) -> None:
        assert self._healing, "apply_pending_state_dict called when not healing"
        self.wait_quorum()  # the quorum thread writes _pending_state_dict
        assert (
            self._pending_state_dict is not None
        ), "checkpoint was not fetched before apply"
        assert self._load_state_dict is not None, "no load_state_dict callback"
        with self._metrics.timed("heal_apply"):
            self._load_state_dict(cast(T, self._pending_state_dict["user"]))
        self._pending_state_dict = None

    # -- data plane --

    def allreduce(self, tree: Any, op: ReduceOp = ReduceOp.AVG,
                  wire: Optional[str] = None) -> Work:
        """Fault-tolerantly averages a gradient tree across replica groups.

        Data-plane errors never raise: the Work resolves to the tree AS
        CONTRIBUTED (zeroed for a healing/spare replica) and the error is
        latched for ``should_commit``. A failed QUORUM does raise (via
        ``wait_quorum``): membership failure means the step cannot
        proceed. ``op`` is AVG (divide by ``num_participants``) or SUM.
        ``wire`` forwards to the collectives (``"q8"``: the quantized
        ring, constant wire bytes in world size)."""
        if op not in (ReduceOp.AVG, ReduceOp.SUM):
            raise ValueError(f"unsupported managed allreduce op: {op}")

        def dispatch(zeroed_tree: Any) -> Work:
            return self._collectives.allreduce(
                zeroed_tree, ReduceOp.SUM, divisor=self._divisor(op),
                wire=wire,
            )

        return self._managed_dispatch("allreduce", tree, dispatch, lambda t: t)

    def allgather(self, tree: Any) -> Work:
        """Fault-tolerantly gathers ``tree`` from every cohort member (a
        list by replica rank). Same discipline as :meth:`allreduce`: a
        non-participating (healing/spare) replica's entry is ZEROED, so
        consumers averaging entry-wise divide by ``num_participants()``,
        and a data-plane failure latches and resolves to ``[tree]``."""
        return self._managed_dispatch(
            "allgather", tree, self._collectives.allgather, lambda t: [t]
        )

    def reduce_scatter(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.AVG,
        wire: Optional[str] = None,
    ) -> Work:
        """Fault-tolerantly reduces a tree but stops at the reduce-scatter
        boundary: resolves to this rank's
        :class:`~torchft_tpu_torch.collectives.TreeShard` of the averaged
        flat-packed tree (update the shard, then :meth:`allgather_into`
        the result). The failure default is ``None``: there is no "as
        contributed" shard, so a failure resolves to ``None``, latches,
        and ``should_commit`` discards the step; treat a ``None`` shard
        as an aborted sync, never as data. ``wire="q8"`` reduces over the
        quantized ring (the shard is full f32)."""
        if op not in (ReduceOp.AVG, ReduceOp.SUM):
            raise ValueError(f"unsupported managed reduce_scatter op: {op}")

        def dispatch(zeroed_tree: Any) -> Work:
            return self._collectives.reduce_scatter(
                zeroed_tree, ReduceOp.SUM, divisor=self._divisor(op),
                wire=wire,
            )

        return self._managed_dispatch(
            "reduce_scatter", tree, dispatch, lambda t: None
        )

    def allgather_into(self, shard: Any, wire: Optional[str] = None) -> Work:
        """Fault-tolerantly gathers every member's (updated) TreeShard back
        into the full tree, the parameter leg of the sharded outer sync
        (``wire="bf16"`` halves its bytes). Failure default ``None``. A
        non-participating member's shard is NOT zeroed: the gathered tree
        is replicated state every member owns a slice of."""
        return self._managed_dispatch(
            "allgather_into", shard,
            lambda s: self._collectives.allgather_into(s, wire=wire),
            lambda s: None, zero_nonparticipating=False,
        )

    def plan_reduce_scatter(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.AVG,
        wire: Optional[str] = None,
        ag_wire: Optional[str] = None,
    ) -> Work:
        """Fault-tolerantly reduces a gradient tree through a sharded comm
        plan, stopping at the reduce-scatter boundary: resolves to this
        rank's :class:`~torchft_tpu_torch.collectives.TreeShard` of the
        averaged flat tree (route the updated shard back through
        :meth:`plan_allgather_into`). The per-step ZeRO grad leg.
        ``wire``: None | "bf16" | "q8" (the shard is full f32 on every
        wire); ``ag_wire`` (None | "bf16") pre-declares the param leg's.
        A failure resolves to ``None`` (the plan's buffers may hold a
        partial result), latches, and ``should_commit`` discards; so does
        a cohort whose leaves the sharded plan cannot take."""
        if op not in (ReduceOp.AVG, ReduceOp.SUM):
            raise ValueError(
                f"unsupported managed plan_reduce_scatter op: {op}")

        def dispatch(zeroed_tree: Any) -> Work:
            return self._collectives.plan_reduce_scatter(
                zeroed_tree, ReduceOp.SUM, divisor=self._divisor(op),
                wire=wire, ag_wire=ag_wire,
            )

        return self._managed_dispatch(
            "plan_reduce_scatter", tree, dispatch, lambda t: None
        )

    def plan_allgather_into(self, shard: Any,
                            wire: Optional[str] = None) -> Work:
        """Fault-tolerantly gathers the cohort's updated plan shards into
        the full tree, the per-step ZeRO param leg; ``wire`` must equal
        the ``ag_wire`` declared at :meth:`plan_reduce_scatter`. Failure
        default ``None``. A non-participating member's shard is NOT
        zeroed: the gathered tree is replicated state every member owns a
        slice of, not a sum of contributions."""
        return self._managed_dispatch(
            "plan_allgather_into", shard,
            lambda s: self._collectives.plan_allgather_into(s, wire=wire),
            lambda s: None, zero_nonparticipating=False,
        )

    def plan_allreduce(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.AVG,
        wire: Optional[str] = None,
        device_pack: Any = True,
        hier: bool = False,
    ) -> Work:
        """Fault-tolerantly averages a gradient tree through a persistent
        comm plan (see ``Collectives.plan_allreduce``). A failed execute
        resolves to ``None`` (the plan's output buffers may hold a partial
        unpack); the error latches and ``should_commit`` discards the
        step. ``wire``: None | "bf16" | "q8" | "q8ef" (reset the carry on
        heal via :meth:`reset_plan_feedback`). ``hier`` runs the two-tier
        schedule; on a cohort that is not hier-capable the dispatch error
        latches and the step is discarded."""
        if op not in (ReduceOp.AVG, ReduceOp.SUM):
            raise ValueError(f"unsupported managed plan_allreduce op: {op}")

        def dispatch(zeroed_tree: Any) -> Work:
            return self._collectives.plan_allreduce(
                zeroed_tree, ReduceOp.SUM, divisor=self._divisor(op),
                wire=wire, device_pack=device_pack, hier=hier,
            )

        return self._managed_dispatch(
            "plan_allreduce", tree, dispatch, lambda t: None
        )

    def allreduce_hier(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.AVG,
        wire: Optional[str] = None,
    ) -> Work:
        """Fault-tolerantly averages a tree over the two-tier schedule
        (``Collectives.allreduce_hier``); ``wire`` (None | "bf16" | "q8")
        encodes the inter-region hop only. Same discipline as
        :meth:`allreduce`: a cohort without a usable topology latches the
        dispatch error and the step is discarded."""
        if op not in (ReduceOp.AVG, ReduceOp.SUM):
            raise ValueError(f"unsupported managed allreduce_hier op: {op}")

        def dispatch(zeroed_tree: Any) -> Work:
            return self._collectives.allreduce_hier(
                zeroed_tree, ReduceOp.SUM, divisor=self._divisor(op),
                wire=wire,
            )

        return self._managed_dispatch(
            "allreduce_hier", tree, dispatch, lambda t: t
        )

    def hier_capable(self) -> bool:
        """Whether the current quorum's data plane built a two-tier
        schedule. Settles the quorum thread first (it writes the maps)."""
        if self._quorum_future is not None:
            self.wait_quorum()
        return self._collectives.hier_capable()

    def replica_regions(self) -> List[str]:
        """The current quorum's region map, by replica rank (empty before
        the first quorum; "" for unlabeled members)."""
        if self._quorum_future is not None:
            self.wait_quorum()
        return list(self._replica_regions)

    def replica_hosts(self) -> List[str]:
        """The current quorum's host map, by replica rank."""
        if self._quorum_future is not None:
            self.wait_quorum()
        return list(self._replica_hosts)

    def _configure_takes_hosts(self) -> bool:
        try:
            params = inspect.signature(self._collectives.configure).parameters
        except (TypeError, ValueError):
            return False
        return "hosts" in params or any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
        )

    def _divisor(self, op: ReduceOp) -> Optional[float]:
        """AVG divides by the participants (healing/spare members
        contribute zeros and don't count), not by the ring size."""
        if op == ReduceOp.SUM:
            return None
        num_participants = self.num_participants()
        assert num_participants >= 1
        return float(num_participants)

    def reset_plan_feedback(self) -> None:
        """Zeroes the error-feedback carry of every cached ``q8ef`` plan,
        native and device-resident: a recovered or rolled-back member must
        not carry a residual from its abandoned trajectory."""
        self._collectives.plan_reset_feedback()

    def _managed_dispatch(
        self,
        op_name: str,
        tree: Any,
        dispatch: Callable[[Any], Work],
        default_factory: Callable[[Any], Any],
        zero_nonparticipating: bool = True,
    ) -> Work:
        """The managed-collective discipline: errored short-circuit, quorum
        join, participant zeroing, span + timer, timeout + error latch.
        Failures after the quorum join resolve to ``default_factory`` of
        the tree as dispatched."""
        if self.errored() is not None:
            return _completed(default_factory(tree))
        self.wait_quorum()
        try:
            if zero_nonparticipating and not self.is_participating():
                tree = tree_map(_zero_leaf, tree)
            t0 = time.perf_counter()
            with span(f"torchft::{op_name}_dispatch"):
                work = dispatch(tree)
            work.add_done_callback(
                lambda _f: self._metrics.record(op_name, time.perf_counter() - t0)
            )
            return self.wrap_work(work, default=default_factory(tree))
        except Exception as e:  # noqa: BLE001 - latch, never raise
            logger.exception(f"{op_name} failed immediately: {e}")
            self.report_error(e)
            return _completed(default_factory(tree))

    def wrap_work(self, work: Work, default: Any) -> Work:
        """Adds a timeout and error-swallowing to a Work: on failure the
        error is latched and ``default`` is returned."""
        timed = work_timeout(work, self._timeout)
        epoch = self._op_epoch
        out: "Future[Any]" = Future()

        def on_done(f: "Future[Any]") -> None:
            exc = f.exception()
            if exc is None:
                out.set_result(f.result())
                return
            logger.error(f"async work failed: {exc!r}")
            with self._error_lock:
                # Work abandoned by an earlier step may settle later; its
                # error belongs to that (already aborted) step.
                if epoch == self._op_epoch:
                    self._errored = cast(Exception, exc)
                    self._force_reconfigure = True
            out.set_result(default)

        timed.add_done_callback(on_done)
        wrapped = Work(out)
        self._pending_work.append(wrapped)
        return wrapped

    # -- error tracking --

    def report_error(self, e: Exception) -> None:
        """Latch an error: the step will not commit, and the next quorum
        rebuilds the data plane (a failed ring op shuts the ring down)."""
        with self._error_lock:
            self._errored = e
            self._force_reconfigure = True

    def errored(self) -> Optional[Exception]:
        return self._errored

    # -- commit protocol --

    def should_commit(self, timeout: Optional[timedelta] = None,
                      count_batches: bool = True) -> bool:
        """Distributed AND-vote on step validity: True iff every rank of
        every participating group completed the step without errors and
        the quorum has at least ``min_replica_size`` participants.
        ``count_batches=False`` marks a control transaction: a commit
        advances the step but not ``batches_committed``. The commit hooks
        run last, on this thread, with the vote final."""
        self.wait_quorum()

        for work in self._pending_work:
            if self._errored is not None:
                break
            work.wait()  # error-swallowing: latches instead of raising
        self._pending_work = []

        # Apply a fetched checkpoint whenever healing, even if an error
        # latched: the step counter already moved to max_step.
        if self._healing:
            self._apply_pending_state_dict()

        local_should_commit = (
            self._errored is None
            and self.num_participants() >= self._min_replica_size
        )
        with self._metrics.timed("commit_vote"), span("torchft::commit_vote"):
            should_commit = self._client.should_commit(
                self._rank,
                self._step,
                local_should_commit,
                timeout=timeout or self._timeout,
            )
        if self._errored is not None:
            logger.warning(
                f"[{self._replica_id}/{self._rank}] step {self._step} "
                f"errored: {self._errored!r}; should_commit={should_commit}"
            )

        # The checkpoint dict must not be readable while the optimizer
        # mutates it.
        self._checkpoint_transport.disallow_checkpoint()

        if should_commit:
            self._step += 1
            if count_batches:
                self._batches_committed += self.num_participants()
        self._metrics.incr("commits" if should_commit else "aborts")
        if self._errored is not None:
            self._metrics.incr("errors")
        self._healing = False
        # The commit boundary: the quorum thread is settled and the vote
        # final, so (step, quorum_id) names one committed fleet state.
        # Hooks are observers: a failing snapshot or publish must never
        # abort training, so their exceptions are logged and dropped.
        for hook in self._commit_hooks:
            try:
                hook(self._step, self._quorum_id, should_commit)
            except Exception as e:  # noqa: BLE001
                logger.warning(f"commit hook failed: {e!r}")
        return should_commit

    # -- state --

    def load_state_dict(self, state_dict: Dict[str, int]) -> None:
        """Restores manager state (alongside the user state)."""
        self._step = int(state_dict["step"])
        self._batches_committed = int(state_dict["batches_committed"])

    def _manager_state_dict(self) -> Dict[str, object]:
        assert self._user_state_dict is not None, "no state_dict callback"
        return {"user": self._user_state_dict(), "torchft": self.state_dict()}

    def state_dict(self) -> Dict[str, int]:
        return {"step": self._step, "batches_committed": self._batches_committed}

    # -- observability / policy signals --

    def observe_op_stats(self) -> List[dict]:
        """Drains the data plane's per-op stats (``pop_op_stats``) through
        the manager, folding them into the rolling throughput
        :meth:`signals` reports: per op ``wire_bytes / ring`` is the
        achieved wire throughput (``wire_eff_MBps``; over its stripes,
        ``wire_conn_MBps``), and per tier of a two-tier op its moved bytes
        over its phase seconds (``tier_<name>_MBps``). Returns the drained
        entries; a backend without op stats yields ``[]``."""
        pop = getattr(self._collectives, "pop_op_stats", None)
        entries: List[dict] = pop() if pop is not None else []
        for st in entries:
            for name, t in (st.get("tiers") or {}).items():
                if name == "inter":
                    phase_s = t.get("ring_s") or 0.0
                else:
                    phase_s = ((t.get("rs_s") or 0.0) + (t.get("ag_s") or 0.0)
                               + (t.get("bcast_s") or 0.0))
                # shm host tiers bill ring movement (their tx_bytes is 0)
                moved = t.get("tx_bytes") or t.get("shm_bytes") or 0
                if phase_s > 0 and moved > 0:
                    tier_eff = moved / phase_s / (1 << 20)
                    self._last_tier_mbps[name] = tier_eff
                    self._metrics.record(f"tier_{name}_MBps", tier_eff)
            ring_s = st.get("ring")
            wire_bytes = st.get("wire_bytes") or st.get("bytes")
            if not ring_s or not wire_bytes or ring_s <= 0:
                continue
            eff = wire_bytes / ring_s / (1 << 20)
            stripes = len(st.get("stripe_s") or ()) or 1
            self._metrics.record("wire_eff_MBps", eff)
            self._metrics.record("wire_conn_MBps", eff / stripes)
            self._last_wire_eff_mbps = eff
        return entries

    def signals(self, churn_window_s: float = 600.0) -> Dict[str, Any]:
        """The policy inputs as one JSON-able dict: ``churn_per_min``
        (reconfigures after the first, over the trailing window),
        ``wire_eff_MBps`` and ``tier_eff_MBps`` (the last observed ring
        and per-tier throughput; ``None`` until :meth:`observe_op_stats`
        saw one), ``heal`` (the transport's ``last_fetch_stats``: path,
        wire, streams, bytes, fetch_s, h2d_s; and the heal timers;
        ``None`` when this replica never healed) and
        ``opt_state_bytes`` (:meth:`report_opt_state_bytes`). Also the
        payload :meth:`push_status` publishes."""
        heal: Optional[Dict[str, Any]] = None
        fetch_stats = getattr(
            self._checkpoint_transport, "last_fetch_stats", None
        )
        timers = self._metrics.snapshot()["timers_s"]
        if fetch_stats is not None or "heal_fetch" in timers:
            heal = {
                "last_fetch": fetch_stats,
                "fetch_s": timers.get("heal_fetch"),
                "apply_s": timers.get("heal_apply"),
            }
        return {
            "churn_per_min": round(
                self._metrics.rate_per_min("churn", churn_window_s), 6
            ),
            "wire_eff_MBps": self._last_wire_eff_mbps,
            "tier_eff_MBps": dict(self._last_tier_mbps) or None,
            "heal": heal,
            "opt_state_bytes": self._opt_state_bytes,
        }

    def report_opt_state_bytes(self, nbytes: Optional[int]) -> None:
        """Records the strategy's resident optimizer-state bytes for
        :meth:`signals`; ``None`` clears the signal."""
        self._opt_state_bytes = None if nbytes is None else int(nbytes)

    def push_status(self, extra: Optional[Dict[str, Any]] = None) -> None:
        """Publishes the :meth:`signals` digest with step/commit progress
        (and ``extra``) to the lighthouse: it rides the native manager's
        lease renewals into this member's entry of ``/status.json``. A
        no-op on group ranks other than 0 (the group's digest is rank
        0's); a failed push is logged, never raised."""
        if self._manager is None:
            return
        counters = self._metrics.snapshot()["counters"]
        status: Dict[str, Any] = {
            "step": self._step,
            "commits": counters.get("commits", 0),
            "aborts": counters.get("aborts", 0),
            "heals": counters.get("heals", 0),
            **self.signals(),
        }
        if extra:
            status.update(extra)
        try:
            self._manager.set_status(status)
        except Exception as e:  # noqa: BLE001 - observability must not kill
            logger.warning(f"status push failed (ignored): {e}")

    # -- introspection --

    def checkpoint_transport(self) -> CheckpointTransport[Dict[str, T]]:
        return self._checkpoint_transport

    def metrics(self) -> Metrics:
        """Step-level counters and timers (commits/aborts/heals/errors,
        quorum / reconfigure / collective / commit-vote latencies)."""
        return self._metrics

    def current_step(self) -> int:
        """Committed step count; skipped steps don't increment it."""
        return self._step

    def replica_id(self) -> str:
        """This group's replica id (the configured name, then a per-run
        uuid): the durable tier keys per-member state on its stable
        prefix."""
        return self._replica_id

    def batches_committed(self) -> int:
        """Batches committed across all replica groups and steps."""
        return self._batches_committed

    def add_commit_hook(self, hook: Callable[[int, int, bool], None]) -> None:
        """Registers ``hook(step, quorum_id, committed)``, run at the end
        of every ``should_commit`` on the training thread, after the step
        counter moved on a commit: the durable tier's capture point and
        the serving plane's publish point. The optimizer has not yet
        written the next step, but card work it queued may still be in
        flight: a hook that reads card state orders itself after the
        current stream (the staging does). Hooks must not raise; an
        exception is logged and dropped."""
        self._commit_hooks.append(hook)

    def set_durable_restore(
        self, fn: Optional[Callable[[], Optional[int]]]
    ) -> None:
        """Registers (or clears) the durable tier's cold-start fallback
        (the ``durable_restore`` argument); ``DurableCheckpointer``
        registers its ``restore_latest`` here when built."""
        self._durable_restore = fn

    def num_participants(self) -> int:
        """Replica groups participating in the current step."""
        assert self._quorum_future is not None, "quorum not started"
        self.wait_quorum()
        return self._participating_world_size

    def quorum_id(self) -> int:
        """Id of the current quorum: it moves exactly when membership, and
        so the data plane, was reconfigured. Sharded state keys on it
        (``ShardedDDP`` re-partitions its optimizer shard when it moved).
        Settles the quorum thread first."""
        assert self._quorum_future is not None, "quorum not started"
        self.wait_quorum()
        return self._quorum_id

    def participating_rank(self) -> Optional[int]:
        """This group's rank among the participants; None while healing
        or a spare. Settles the quorum thread first."""
        assert self._quorum_future is not None, "quorum not started"
        self.wait_quorum()
        return self._participating_rank

    def is_participating(self) -> bool:
        """False while healing or a spare: gradients are zeroed then. A
        synchronous quorum never leaves a member healing here (the heal
        applied in ``start_quorum``)."""
        if self._participating_rank is None:
            return False
        if self._healing:
            assert self._use_async_quorum
            return False
        return True

    def is_healing(self) -> bool:
        """True while this step recovers state from a peer (applied at the
        ``should_commit`` safe point). Settles the quorum thread first."""
        assert self._quorum_future is not None, "quorum not started"
        self.wait_quorum()
        return self._healing

"""Isolated collectives: the compiled data plane in a disposable child.

The port of ``torchft_tpu/isolated_xla.py``. The reference runs NCCL in a
killable subprocess ("Baby" process groups, reference
torchft/process_group.py:551-1064) so that a collective wedged on a
dead peer costs a SIGKILL and a respawn instead of a stuck trainer. The
JAX package puts its ``jax.distributed`` runtime there; this module puts
a torch process group there:

- :class:`IsolatedXLACollectives` (the parent half) owns no process
  group. Payloads are laid out into POSIX shared-memory segments with the
  CommPlan leaf -> offset discipline (the native ``tft_shm_layout_json``
  authority: one flat buffer per accumulation dtype, 64-byte-aligned
  group bases); card tensors never leave the parent, which copies them
  down into the segment and the result back up. Commands cross a
  line-JSON channel that is polled against the child's pid (the
  reference's ``_MonitoredQueue`` role), and a child's exception
  re-raises in the parent with the child's traceback.
- The CHILD maps the same segments and runs
  :class:`~.xla_collectives.XLACollectives` with ``backend="gloo"`` on
  ``torch.frombuffer`` views of them (the ``"psum"`` path): it reduces on
  the host and never opens a CUDA context, so one card holds every
  group's child. Where the compiled path fails its configure-time probe,
  the child reduces through the store instead (``"store"``: every member
  publishes its bytes and sums the members' in rank order). The verdict
  is measured and stamped into every op's stats. The decision to probe
  is one cohort-wide decision rank 0 publishes through the store, so an
  elastic joiner without a hint never probes alone.
- ``configure()`` onto a new membership is SIGKILL + respawn + store
  rendezvous: the parent's tensors are untouched, and a peer that is
  alive but stuck costs at most one op deadline. Under the Manager a
  child's death resolves the op to ``None``, latches, the vote discards
  the step and the next quorum's configure respawns.

Respawn is import-warm: a single-threaded fork server (the zygote,
``TORCHFT_ISO_ZYGOTE=0`` disables it) imports torch and the port once,
never initialises CUDA (forking after that is undefined), and keeps one
pre-forked spare; the parent also parks one connected spare child after
every configure. ``python -m torchft_tpu_torch.isolated_xla --child
HOST:PORT`` is the child's entry, ``--zygote`` the fork server's.
"""

from __future__ import annotations

import contextlib
import json
import os
import select
import signal
import socket
import subprocess
import sys
import threading
import time
import uuid
import warnings
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FuturesTimeout
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import _native
from ._tree import flatten as _flatten
from ._tree import unflatten as _unflatten
from .collectives import (
    _NATIVE_DTYPES,
    Collectives,
    OpStatsMixin,
    ReduceOp,
    Work,
    _caller_event,
    _divide_,
    _identity,
)
from .quantize import _views, flat_buffer

# Payload-slot window of the store path: op n's keys reuse slot n % window.
# A member runs at most one op ahead of the slowest reader (finishing op n
# needs every member to have started it), so any window >= 2 keeps a
# writer off an in-flight read; read freshness also needs the per-(slot,
# rank) version key (_child_store_exchange). The store keeps, per quorum
# prefix, up to window * world of each slot's largest payload, dropped
# with the prefix.
_STORE_SLOTS = 4

# Store values ride the native wire protocol, whose frames cap at 64 MB:
# payloads go in fixed-size chunks. Every member ships the same layout
# total, so both sides derive the chunk count.
_STORE_CHUNK = 16 << 20

# Modules a child must never hold (the port imports neither).
_FOREIGN_ROOTS = ("jax", "jaxlib", "optax", "ml_dtypes", "torchft_tpu")


def _liveness_interval_s() -> float:
    """How often the channel polls the child's pid while waiting for a
    reply (``TORCHFT_ISO_LIVENESS_MS``, default 100): the bound on how long
    a dead child can pass for a slow one."""
    try:
        return max(int(os.environ.get("TORCHFT_ISO_LIVENESS_MS", "100")), 10) / 1e3
    except ValueError:
        return 0.1


def _zygote_enabled() -> bool:
    return os.environ.get("TORCHFT_ISO_ZYGOTE", "1") != "0"


def _stall_grace_s() -> float:
    """How long the child may sit stopped before the stall verdict
    (``TORCHFT_ISO_STALL_MS``, default 1500), always within the op
    deadline."""
    try:
        return max(int(os.environ.get("TORCHFT_ISO_STALL_MS", "1500")), 50) / 1e3
    except ValueError:
        return 1.5


def _proc_state(pid: int) -> Optional[str]:
    """The one-letter process state of ``/proc/<pid>/stat`` ("R", "S",
    "T", ...), None when unreadable (dead, or no procfs: the stall verdict
    then never fires and the op deadline rules)."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            data = f.read()
        # the state follows the parenthesized comm, which may hold parens
        end = data.rindex(b")")
        return data[end + 2:end + 3].decode()
    except (OSError, ValueError, IndexError):
        return None


class ChildDiedError(RuntimeError):
    """The isolated child exited (or was killed) while the parent talked
    to it. Latches through the managed discipline like any data-plane
    error; the next quorum's configure respawns."""


class ChildStalledError(ChildDiedError):
    """The isolated child is alive but STOPPED ('T' state): a pid poll
    cannot tell that from slow. The channel issues this stall verdict once
    the child has been stopped for the stall grace (within the op
    deadline), and the parent SIGKILLs it, which a stopped process cannot
    block; recovery is then the SIGKILL path's."""


def _child_env() -> Dict[str, str]:
    """The environment a child runs under, for both spawn paths: the
    parent's current one with the repository prepended to PYTHONPATH."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _apply_child_env(env: Dict[str, str]) -> None:
    """A forked child REPLACES the zygote's startup environment with the
    shipped one (clear, then update): a variable the parent unset since
    the zygote started does not leak through the fork."""
    os.environ.clear()
    os.environ.update(env)


# --------------------------------------------------------------------------
# the monitored channel: line JSON over a socket, polled against the pid
# --------------------------------------------------------------------------


class _MonitoredChannel:
    """A command/reply pipe that never outwaits a dead peer: ``recv``
    polls the child's liveness between select ticks, so a killed child
    surfaces as :class:`ChildDiedError` within one liveness interval, and
    (given the pid) a stopped one as :class:`ChildStalledError` within the
    stall grace. Child errors re-raise here with the child's traceback."""

    def __init__(self, sock: socket.socket,
                 alive: Callable[[], Optional[int]],
                 pid: Optional[int] = None) -> None:
        self._sock = sock
        self._alive = alive  # the exit code once dead, None while alive
        self._pid = pid
        self._buf = b""

    def send(self, msg: dict) -> None:
        try:
            self._sock.sendall(json.dumps(msg).encode() + b"\n")
        except OSError as e:
            raise ChildDiedError(
                f"isolated child unreachable on send: {e}") from e

    def recv(self, timeout_s: float) -> dict:
        deadline = time.perf_counter() + timeout_s
        tick = _liveness_interval_s()
        stall_grace = min(_stall_grace_s(), timeout_s)
        stopped_since: Optional[float] = None
        while b"\n" not in self._buf:
            rc = self._alive()
            if rc is not None:
                raise ChildDiedError(f"isolated child died (rc={rc}) mid-op")
            if self._pid is not None:
                now = time.perf_counter()
                if _proc_state(self._pid) in ("T", "t"):
                    if stopped_since is None:
                        stopped_since = now
                    elif now - stopped_since >= stall_grace:
                        raise ChildStalledError(
                            "isolated child STALLED (stopped for "
                            f"{now - stopped_since:.2f}s, pid {self._pid}): "
                            "alive to the liveness poll but not running")
                else:
                    stopped_since = None
            remain = deadline - time.perf_counter()
            if remain <= 0:
                if (self._pid is not None
                        and _proc_state(self._pid) in ("T", "t")):
                    raise ChildStalledError(
                        f"isolated child STALLED (stopped at the "
                        f"{timeout_s:.1f}s op deadline, pid {self._pid})")
                raise TimeoutError(
                    f"isolated child reply timed out after {timeout_s:.1f}s")
            try:
                ready, _, _ = select.select([self._sock], [], [],
                                            min(tick, remain))
                if not ready:
                    continue
                chunk = self._sock.recv(1 << 16)
            except (OSError, ValueError) as e:
                # kill_child() closed the socket under us: fail fast
                raise ChildDiedError(
                    f"isolated channel closed mid-op: {e}") from e
            if not chunk:
                raise ChildDiedError(
                    f"isolated child closed its channel (rc={self._alive()})")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        msg = json.loads(line)
        if "error" in msg:
            raise RuntimeError(
                "isolated child error: " + msg["error"]
                + ("\n--- child traceback ---\n" + msg["tb"]
                   if msg.get("tb") else ""))
        return msg

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


# --------------------------------------------------------------------------
# child handles: zygote fork or classic spawn
# --------------------------------------------------------------------------


class _ChildHandle:
    """One pid-level surface over a forked or spawned child;
    ``spawn_mode`` says which path made it ("zygote" | "classic")."""

    def __init__(self, pid: int, poll: Callable[[], Optional[int]],
                 reap: Optional[Callable[..., Any]] = None,
                 spawn_mode: str = "unknown") -> None:
        self.pid = pid
        self._poll = poll
        # Reaps a classic spawn (Popen.wait); the zygote reaps its forks,
        # a classic child has no other reaper and would stay a zombie.
        self._reap = reap
        self.spawn_mode = spawn_mode

    def poll(self) -> Optional[int]:
        return self._poll()

    def kill(self) -> None:
        try:
            os.kill(self.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        if self._reap is not None:
            try:
                self._reap(timeout=5)
            except Exception:  # noqa: BLE001 - best-effort reaping
                pass


_ENTRY = "from torchft_tpu_torch.isolated_xla import main; main()"


class _Zygote:
    """The import-warm fork server: pays the torch import once in a
    single-threaded helper that never initialises CUDA, then forks a
    ready child per request (a respawn costs a fork, not an interpreter
    start). Line JSON: ``{"connect": "host:port", "env": {...}}`` -> fork
    -> ``{"pid": P}``; reaped children surface as ``{"exit": P, "rc":
    RC}`` (kills as negative signal numbers)."""

    def __init__(self) -> None:
        # not `-m`: runpy re-executing a submodule of the imported package
        # warns and runs its module state twice
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _ENTRY, "--zygote"], env=_child_env(),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            bufsize=1)
        self.exit_codes: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._responses: List[dict] = []
        self._resp_cv = threading.Condition()
        threading.Thread(target=self._read, daemon=True,
                         name="iso_zygote_reader").start()
        msg = self._wait_response(timeout=120.0)
        if not msg.get("ready"):
            raise RuntimeError(f"iso zygote failed to warm: {msg}")

    def _wait_response(self, timeout: float) -> dict:
        with self._resp_cv:
            deadline = time.monotonic() + timeout
            while not self._responses:
                remain = deadline - time.monotonic()
                if remain <= 0 or not self.alive():
                    raise RuntimeError("iso zygote unresponsive")
                self._resp_cv.wait(min(remain, 0.2))
            return self._responses.pop(0)

    def _read(self) -> None:
        try:
            for line in self.proc.stdout:
                msg = json.loads(line)
                if "exit" in msg:
                    self.exit_codes[msg["exit"]] = msg["rc"]
                else:
                    if "pid" in msg:
                        # pid reuse: clear a stale exit code in pipe order
                        self.exit_codes.pop(msg["pid"], None)
                    with self._resp_cv:
                        self._responses.append(msg)
                        self._resp_cv.notify_all()
        except Exception:  # noqa: BLE001 - zygote gone; spawns fall back
            pass

    def spawn(self, connect: str, env: Dict[str, str]) -> _ChildHandle:
        with self._lock:
            self.proc.stdin.write(json.dumps({"connect": connect,
                                              "env": env}) + "\n")
            self.proc.stdin.flush()
            msg = self._wait_response(timeout=60.0)
        pid = msg.get("pid")
        if pid is None:
            # both parked spares died before activation: fail now, so the
            # caller spawns classically instead of waiting out a connect
            raise RuntimeError(f"iso zygote spawn failed: {msg}")

        def poll() -> Optional[int]:
            rc = self.exit_codes.get(pid)
            if rc is not None:
                return rc
            if not self.alive():
                # zygote gone: probe the child itself
                try:
                    os.kill(pid, 0)
                except ProcessLookupError:
                    return -9
            return None

        return _ChildHandle(pid, poll, spawn_mode="zygote")

    def alive(self) -> bool:
        return self.proc.poll() is None

    def shutdown(self) -> None:
        try:
            self.proc.kill()
        except Exception:  # noqa: BLE001
            pass


_zygote: Optional[_Zygote] = None
_zygote_failed = False
_zygote_lock = threading.Lock()


def _get_zygote() -> Optional[_Zygote]:
    global _zygote, _zygote_failed
    if not _zygote_enabled() or _zygote_failed:
        return None
    with _zygote_lock:
        if _zygote is not None and _zygote.alive():
            return _zygote
        try:
            _zygote = _Zygote()
        except Exception:  # noqa: BLE001 - classic spawns still work
            _zygote_failed = True
            _zygote = None
        return _zygote


def _spawn_child(connect: str) -> _ChildHandle:
    """A fork of the import-warm zygote when there is one, else a classic
    interpreter spawn; both land in ``_child_connect(connect)``."""
    zyg = _get_zygote()
    if zyg is not None:
        try:
            # the whole current environment: the fork replaces the
            # zygote's startup snapshot with it
            return zyg.spawn(connect, _child_env())
        except Exception:  # noqa: BLE001 - zygote wedged: classic spawn
            pass
    proc = subprocess.Popen([sys.executable, "-c", _ENTRY, "--child", connect],
                            env=_child_env())
    return _ChildHandle(proc.pid, proc.poll, reap=proc.wait,
                        spawn_mode="classic")


# --------------------------------------------------------------------------
# layout helpers (both sides)
# --------------------------------------------------------------------------

Sig = Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    """A leaf's accumulation dtype, the host ring's rule: native dtypes
    as themselves, everything else through f32."""
    return dt if dt in _NATIVE_DTYPES else torch.float32


def _sig_layout(sig: Sig) -> dict:
    """The native CommPlan layout of a (shape, dtype) signature at wire 0,
    the one authority both sides build their segment views from."""
    counts = [int(torch.Size(s).numel()) for s, _ in sig]
    codes = [_NATIVE_DTYPES[_acc_dtype(dt)] for _, dt in sig]
    return _native.shm_layout(counts, codes, 0)


_CODE_TO_DTYPE = {v: k for k, v in _NATIVE_DTYPES.items()}


def _view(buf: Any, dtype: torch.dtype, count: int, offset: int) -> torch.Tensor:
    """A zero-copy 1-D tensor over ``count`` elements of a mapped segment
    (or a payload) at byte ``offset``."""
    if count == 0:
        return torch.empty(0, dtype=dtype)
    with warnings.catch_warnings():
        # store payloads are read-only bytes; they are only read
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(buf, dtype=dtype, count=count, offset=offset)


def _group_views(buf: Any, layout: dict, base: int = 0) -> List[torch.Tensor]:
    """One flat view per layout group."""
    return [_view(buf, _CODE_TO_DTYPE[g["dtype"]], g["count"],
                  base + g["offset"]) for g in layout["groups"]]


def _leaf_views(buf: Any, layout: dict, sig: Sig,
                base: int = 0) -> List[torch.Tensor]:
    """One shaped view per leaf (the persistent staging the parent
    writes into: no per-step allocation once built)."""
    out = []
    for (shape, _), leaf in zip(sig, layout["leaves"]):
        g = layout["groups"][leaf["group"]]
        dt = _CODE_TO_DTYPE[g["dtype"]]
        off = base + g["offset"] + leaf["off"] * dt.itemsize
        out.append(_view(buf, dt, leaf["count"], off).view(shape))
    return out


# --------------------------------------------------------------------------
# parent: IsolatedXLACollectives
# --------------------------------------------------------------------------


class _Staging:
    """Per-signature persistent views into the in/out segments, rebuilt
    only when a segment regrows or the signature changes."""

    def __init__(self, sig: Sig, in_seg: "_native.ShmSegment",
                 out_seg: "_native.ShmSegment", members: int) -> None:
        self.sig = sig
        self.layout = _sig_layout(sig)
        self.total = self.layout["total_bytes"]
        in_buf = in_seg.buffer()
        out_buf = out_seg.buffer()
        self.in_leaves = _leaf_views(in_buf, self.layout, sig)
        self.in_groups = _group_views(in_buf, self.layout)
        self.out_groups = _group_views(out_buf, self.layout)
        # allgather reads member r's block at stride `total` (built where
        # the out segment was sized for it)
        self.out_members = [_group_views(out_buf, self.layout,
                                         base=r * self.total)
                            for r in range(members)]
        # each group's leaves, in layout order (consecutive in the group)
        self.group_leaves = [[] for _ in self.layout["groups"]]
        for i, leaf in enumerate(self.layout["leaves"]):
            self.group_leaves[leaf["group"]].append(i)


class IsolatedXLACollectives(OpStatsMixin, Collectives):
    """Cross-group collectives whose process group lives in a disposable
    child (module docstring): a membership change is kill-and-respawn at
    step granularity, and a wedged collective costs one op deadline.
    Results come back on the input leaves' devices, as the host ring
    returns them; there is no ``keep_global`` form, since the group is
    the child's."""

    def __init__(self, timeout: timedelta = timedelta(seconds=60),
                 connect_timeout: timedelta = timedelta(seconds=60)) -> None:
        self._timeout = timeout
        self._connect_timeout = connect_timeout
        self._rank = -1
        self._world_size = 0
        # One thread: collectives must issue in submission order.
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="isolated_xla")
        self._shutdown = False
        self._aborted = False
        # The live child: written on the op thread (configure), killed
        # from any thread (abort, configure's entry).
        self._child_lock = threading.Lock()
        self._child: Optional[_ChildHandle] = None
        self._channel: Optional[_MonitoredChannel] = None
        # Configure generation (under _child_lock): every configure entry,
        # abort and shutdown bumps it; a do_configure that no longer holds
        # the current one never installs a child or flips _path/_aborted.
        self._cfg_gen = 0
        # the parked spare: (handle, connected channel)
        self._spare: Optional[Tuple[_ChildHandle, _MonitoredChannel]] = None
        # Segments grow only, regenerated under a fresh name (the child
        # re-attaches by the name every op carries).
        self._segs: Dict[str, Optional[_native.ShmSegment]] = {
            "in": None, "out": None}
        self._seg_gen = 0
        self._uid = uuid.uuid4().hex[:12]
        self._staging: Dict[Any, Tuple[int, _Staging]] = {}
        self._side_streams: Dict[torch.device, Any] = {}
        self._path = "unconfigured"  # "psum" | "store" | "solo"
        self._last_spawn_mode = "none"
        # Constructing this backend declares the intent to spawn: the
        # fork server warms (the torch import) behind the caller's setup.
        if _zygote_enabled():
            threading.Thread(target=_get_zygote, daemon=True,
                             name="iso_zygote_warm").start()

    # -- child lifecycle --

    def _kill_child_locked(self) -> None:
        if self._channel is not None:
            self._channel.close()
            self._channel = None
        if self._child is not None:
            self._child.kill()
            self._child = None

    def kill_child(self) -> None:
        """SIGKILLs the current child (any thread): an in-flight op fails
        fast with :class:`ChildDiedError` and the next ``configure()``
        respawns. ``abort()`` calls it."""
        with self._child_lock:
            self._kill_child_locked()

    def abort(self) -> None:
        self._aborted = True
        with self._child_lock:
            self._cfg_gen += 1  # cancels an in-flight configure too
            self._kill_child_locked()

    def _spawn_and_connect_detached(
            self) -> Tuple[_ChildHandle, _MonitoredChannel]:
        """Spawns a child and waits for its hello, without installing it
        (configure and the spare pre-spawner both build on this)."""
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.bind(("127.0.0.1", 0))
        listener.listen(1)
        addr = f"127.0.0.1:{listener.getsockname()[1]}"
        child = _spawn_child(addr)
        listener.settimeout(self._connect_timeout.total_seconds())
        try:
            sock, _ = listener.accept()
        except socket.timeout:
            child.kill()
            raise TimeoutError(
                "isolated child did not connect within "
                f"{self._connect_timeout.total_seconds():.0f}s "
                f"(pid {child.pid}, rc={child.poll()})") from None
        finally:
            listener.close()
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        channel = _MonitoredChannel(sock, child.poll, pid=child.pid)
        hello = channel.recv(self._connect_timeout.total_seconds())
        if "hello" not in hello:
            channel.close()
            child.kill()
            raise RuntimeError(f"isolated child sent no hello: {hello}")
        return child, channel

    def _install_child(self, child: _ChildHandle, channel: _MonitoredChannel,
                       gen: int) -> None:
        """Installs iff ``gen`` is still the current generation; a stale
        install kills the fresh child instead of leaking it."""
        with self._child_lock:
            if gen == self._cfg_gen:
                self._child, self._channel = child, channel
                return
        channel.close()
        child.kill()
        raise RuntimeError("isolated configure superseded by a newer "
                           "configure/abort/shutdown")

    def _take_or_spawn_child(self, gen: int) -> _MonitoredChannel:
        """Installs the parked spare where it is alive, else spawns now.
        The spare makes a reconfigure cost the activation round trip
        whatever a fork costs on the platform."""
        with self._child_lock:
            spare, self._spare = self._spare, None
        if spare is not None:
            child, channel = spare
            if child.poll() is None:
                self._install_child(child, channel, gen)
                self._last_spawn_mode = "spare"
                return channel
            channel.close()
            child.kill()
        child, channel = self._spawn_and_connect_detached()
        self._install_child(child, channel, gen)
        self._last_spawn_mode = child.spawn_mode
        return channel

    def _prespawn_spare(self) -> None:
        """Arms the next spare in the background; gives up quietly (the
        next configure then spawns and surfaces the real error)."""

        def arm() -> None:
            try:
                child, channel = self._spawn_and_connect_detached()
            except Exception:  # noqa: BLE001
                return
            with self._child_lock:
                keep = not self._shutdown and self._spare is None
                if keep:
                    self._spare = (child, channel)
            if not keep:
                channel.close()
                child.kill()

        threading.Thread(target=arm, daemon=True,
                         name="iso_spare_arm").start()

    def configure(
        self,
        store_addr: str,
        rank: int,
        world_size: int,
        regions: Optional[Sequence[str]] = None,
        hosts: Optional[Sequence[str]] = None,
    ) -> None:
        """Kill-and-respawn reconfigure: the old child, wedged or not, is
        SIGKILLed from the calling thread (unblocking an op stuck on it),
        and a fresh child rendezvouses on the new prefix. The parent's
        tensors are untouched. ``regions``/``hosts`` are accepted and
        ignored."""
        t_kill = time.perf_counter()
        self._aborted = True
        with self._child_lock:
            self._cfg_gen += 1
            gen = self._cfg_gen
            respawn = self._child is not None
            self._kill_child_locked()

        def superseded() -> bool:
            with self._child_lock:
                return gen != self._cfg_gen

        def do_configure() -> None:
            if superseded():
                raise RuntimeError("isolated configure superseded")
            self._rank = rank
            self._world_size = world_size
            self._staging.clear()
            if world_size <= 1:
                # no peer can wedge a solo cohort: ops stay in the parent
                with self._child_lock:
                    if gen != self._cfg_gen:
                        raise RuntimeError("isolated configure superseded")
                    self._path = "solo"
                    self._aborted = False
                return
            t0 = time.perf_counter()
            channel = self._take_or_spawn_child(gen)
            t1 = time.perf_counter()
            channel.send({
                "cmd": "configure",
                "store_addr": store_addr,
                "rank": rank,
                "world_size": world_size,
                "connect_timeout_s": self._connect_timeout.total_seconds(),
                "timeout_s": self._timeout.total_seconds(),
                # advisory: rank 0's child publishes one cohort-wide
                # decision (see _child_configure)
                "path_hint": self._path if self._path in ("psum", "store")
                else None,
            })
            reply = channel.recv(self._connect_timeout.total_seconds()
                                 + self._timeout.total_seconds())
            with self._child_lock:
                if gen != self._cfg_gen:
                    # superseded mid-flight: the child belongs to a stale
                    # quorum prefix
                    self._kill_child_locked()
                    raise RuntimeError("isolated configure superseded")
                self._path = reply["path"]
                self._aborted = False
            self._record_op_stats({
                "op": "configure",
                "backend": "iso",
                "path": reply["path"],
                "respawn": respawn,
                "spawn_mode": self._last_spawn_mode,
                "kill_s": t0 - t_kill,
                "spawn_s": t1 - t0,
                "child_init_s": reply.get("init_s", 0.0),
                "rendezvous_s": time.perf_counter() - t1,
            })
            self._prespawn_spare()  # the next child, off any critical path

        fut = self._executor.submit(do_configure)
        try:
            fut.result(timeout=self._outer_configure_timeout_s())
        except _FuturesTimeout:
            # abandoned mid-flight: its generation can never install
            with self._child_lock:
                self._cfg_gen += 1
                self._kill_child_locked()
            raise

    def _outer_configure_timeout_s(self) -> float:
        """The bound on the whole configure: it covers the inner deadlines
        (spawn accept <= connect, hello <= connect, reply <= connect +
        op), so a slow but healthy configure is not abandoned."""
        return (3 * self._connect_timeout.total_seconds()
                + self._timeout.total_seconds() + 10.0)

    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        with self._child_lock:
            self._cfg_gen += 1  # a straggling configure cannot install
            if self._channel is not None:
                try:
                    self._channel.send({"cmd": "exit"})
                except Exception:  # noqa: BLE001 - the kill covers it
                    pass
            self._kill_child_locked()
            spare, self._spare = self._spare, None
        if spare is not None:
            spare[1].close()
            spare[0].kill()
        self._executor.shutdown(wait=True)
        # drop every staging view before the close unmaps its pages
        self._staging.clear()
        for name, seg in self._segs.items():
            if seg is not None:
                seg.close()
            self._segs[name] = None

    def size(self) -> int:
        return self._world_size

    def rank(self) -> int:
        return self._rank

    def child_pid(self) -> Optional[int]:
        """The live child's pid (None without one)."""
        with self._child_lock:
            return self._child.pid if self._child is not None else None

    def reduction_path(self) -> str:
        """The configure's verdict: ``"psum"`` (the child's process
        group), ``"store"`` (the store reduction), ``"solo"``."""
        return self._path

    def child_status(self) -> Work:
        """The live child's own report, in op order: its pid, whether it
        initialised CUDA, and any module of JAX or of the JAX package it
        holds."""
        return self._submit(lambda: self._roundtrip(
            {"cmd": "status"}, self._timeout.total_seconds()))

    # -- segments & staging --

    def _seg_name(self, kind: str) -> str:
        return f"tft_iso_{os.getpid()}_{self._uid}_{kind}_{self._seg_gen}"

    def _ensure_segment(self, kind: str, nbytes: int) -> "_native.ShmSegment":
        seg = self._segs[kind]
        if seg is not None and seg.nbytes >= nbytes:
            return seg
        # Grow-only, under a fresh name: the old creator handle unlinks
        # its name at close, the child's old mapping stays valid until it
        # re-attaches.
        self._seg_gen += 1
        new = _native.ShmSegment.create(self._seg_name(kind),
                                        max(nbytes, 1 << 16))
        if seg is not None:
            # every cached staging holds views of the old mapping: evict
            # them all before the close unmaps the pages under them
            self._staging.clear()
            seg.close()
        self._segs[kind] = new
        return new

    def _staging_for(self, sig: Sig, out_mult: int) -> _Staging:
        key = (sig, out_mult >= 2)
        cached = self._staging.get(key)
        if cached is not None and cached[0] == self._seg_gen:
            return cached[1]
        total = _sig_layout(sig)["total_bytes"]
        self._ensure_segment("in", total)
        self._ensure_segment("out", total * max(out_mult, 1))
        # the final handles: either ensure may have regenerated
        staging = _Staging(sig, self._segs["in"], self._segs["out"],
                           max(out_mult, 1))
        self._staging[key] = (self._seg_gen, staging)
        return staging

    # -- ops --

    def _submit(self, fn: Callable[[], Any]) -> Work:
        if self._shutdown:
            raise RuntimeError("collectives already shut down")

        def guarded() -> Any:
            if self._aborted:
                raise RuntimeError("collectives aborted")
            return fn()

        return Work(self._executor.submit(guarded))

    def _side_stream(self, device: torch.device) -> Any:
        stream = self._side_streams.get(device)
        if stream is None:
            stream = self._side_streams[device] = torch.cuda.Stream(device)
        return stream

    def _on_side(self, caller: Optional[Tuple[Any, Any]]) -> Any:
        if caller is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._side_stream(caller[0].device))

    def _write_leaves(self, leaves: Sequence[torch.Tensor], staging: _Staging,
                      caller: Optional[Tuple[Any, Any]]) -> int:
        """Copies the leaves into the in segment (a group whose leaves are
        views of one flat buffer in one copy); returns the bytes that
        crossed the card link. Card copies run on a side stream behind the
        caller's event, so work queued after the dispatch does not delay
        them."""
        if caller is not None:
            self._side_stream(caller[0].device).wait_event(caller[1])
        d2h = 0
        with torch.no_grad(), self._on_side(caller):
            for g, idxs in enumerate(staging.group_leaves):
                group = [leaves[i] for i in idxs]
                view = staging.in_groups[g]
                if any(l.is_cuda for l in group):
                    d2h += view.numel() * view.element_size()
                flat = flat_buffer(group, view.dtype)
                if flat is not None:
                    view.copy_(flat)
                    continue
                for i in idxs:
                    staging.in_leaves[i].copy_(leaves[i])
        return d2h

    def _read_leaves(self, groups: Sequence[torch.Tensor], sig: Sig,
                     staging: _Staging, leaves: Sequence[torch.Tensor],
                     caller: Optional[Tuple[Any, Any]]) -> List[torch.Tensor]:
        """The result out of the segment's group views onto each leaf's
        device, in its dtype: a copy (the views alias pages the next op
        overwrites), one per group whose leaves share a device, with the
        leaves as views of it. An upload runs on the side stream and has
        landed when this returns; the result is marked in use by the
        caller's stream."""
        out: List[Optional[torch.Tensor]] = [None] * len(sig)
        with self._on_side(caller):
            for g, idxs in enumerate(staging.group_leaves):
                if not idxs:
                    continue
                shapes = [torch.Size(sig[i][0]) for i in idxs]
                devs = {leaves[i].device for i in idxs}
                if len(devs) > 1:
                    for i, v in zip(idxs, _views(groups[g], shapes)):
                        out[i] = v.to(leaves[i].device, sig[i][1], copy=True)
                    continue
                landed = groups[g].to(devs.pop(), copy=True)
                if caller is not None and landed.is_cuda:
                    landed.record_stream(caller[0])
                for i, v in zip(idxs, _views(landed, shapes)):
                    out[i] = v if v.dtype == sig[i][1] else v.to(sig[i][1])
        return out  # type: ignore[return-value]

    def _roundtrip(self, cmd: dict, timeout_s: float) -> dict:
        with self._child_lock:
            channel = self._channel
        if channel is None:
            raise ChildDiedError(
                "no isolated child (killed or never configured)")
        channel.send(cmd)
        try:
            return channel.recv(timeout_s)
        except (TimeoutError, ChildStalledError):
            # The channel has no correlation ids: a late reply would pass
            # for the next op's. A child that outwaited its deadline, or
            # sits stopped, is wedged: SIGKILL it, which also fails its
            # peers' collective now instead of at their deadline. The
            # next configure respawns.
            self.kill_child()
            raise

    def _op_cmd(self, op: str, staging: _Staging, **extra: Any) -> dict:
        leaves = staging.layout["leaves"]
        groups = staging.layout["groups"]
        return {
            "cmd": "op",
            "op": op,
            "counts": [l["count"] for l in leaves],
            "leaf_codes": [groups[l["group"]]["dtype"] for l in leaves],
            "seg_in": self._segs["in"].name,
            "seg_in_bytes": self._segs["in"].nbytes,
            "seg_out": self._segs["out"].name,
            "seg_out_bytes": self._segs["out"].nbytes,
            "timeout_s": self._timeout.total_seconds(),
            **extra,
        }

    def allreduce(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.SUM,
        divisor: Optional[float] = None,
        wire: Optional[str] = None,
    ) -> Work:
        # wire="q8" is accepted and served losslessly, the XLACollectives
        # contract: the quantized wire exists for the host ring's links.
        caller = _caller_event(tree)
        return self._submit(
            lambda: self._allreduce_sync(tree, op, divisor, caller))

    def _allreduce_sync(self, tree: Any, op: ReduceOp,
                        divisor: Optional[float],
                        caller: Optional[Tuple[Any, Any]] = None) -> Any:
        if divisor is not None and op not in (ReduceOp.SUM, ReduceOp.AVG):
            raise ValueError("divisor only composes with ReduceOp.SUM")
        if op == ReduceOp.AVG:
            if divisor is not None:
                raise ValueError("divisor only composes with ReduceOp.SUM")
            divisor, op = float(self._world_size), ReduceOp.SUM
        leaves, treedef = _flatten(tree)
        if self._world_size == 1 or not leaves:
            return _identity(tree, leaves, treedef, divisor)
        sig = tuple((tuple(l.shape), l.dtype) for l in leaves)
        t0 = time.perf_counter()
        staging = self._staging_for(sig, out_mult=1)
        t1 = time.perf_counter()
        d2h = self._write_leaves(leaves, staging, caller)
        t2 = time.perf_counter()
        reply = self._roundtrip(
            self._op_cmd("allreduce", staging, opcode=int(op),
                         divisor=divisor),
            # slack over the child's own deadline, so its timeout error
            # (with the child's traceback) arrives first
            self._timeout.total_seconds() + 5.0)
        t3 = time.perf_counter()
        out = self._read_leaves(staging.out_groups, sig, staging, leaves,
                                caller)
        self._record_op_stats({
            "op": "allreduce",
            "backend": "iso",
            "path": reply.get("path", self._path),
            "bytes": staging.total,
            "d2h_bytes": d2h,
            "pack": t1 - t0,
            "d2h": t2 - t1,
            "ring": t3 - t2,
            "child_s": reply.get("ring_s", 0.0),
            "h2d": time.perf_counter() - t3,
        })
        return _unflatten(treedef, out)

    def allgather(self, tree: Any) -> Work:
        caller = _caller_event(tree)
        return self._submit(lambda: self._allgather_sync(tree, caller))

    def _allgather_sync(self, tree: Any,
                        caller: Optional[Tuple[Any, Any]] = None) -> List[Any]:
        if self._world_size == 1:
            return [tree]
        leaves, treedef = _flatten(tree)
        if not leaves:
            return [tree] * self._world_size
        sig = tuple((tuple(l.shape), l.dtype) for l in leaves)
        staging = self._staging_for(sig, out_mult=self._world_size)
        d2h = self._write_leaves(leaves, staging, caller)
        t0 = time.perf_counter()
        reply = self._roundtrip(self._op_cmd("allgather", staging),
                                self._timeout.total_seconds() + 5.0)
        ring_s = time.perf_counter() - t0
        results = [
            _unflatten(treedef, self._read_leaves(
                staging.out_members[r], sig, staging, leaves, caller))
            for r in range(self._world_size)]
        self._record_op_stats({
            "op": "allgather",
            "backend": "iso",
            "path": reply.get("path", self._path),
            "bytes": staging.total,
            "d2h_bytes": d2h,
            "ring": ring_s,
            "child_s": reply.get("ring_s", 0.0),
        })
        return results

    def broadcast(self, tree: Any, root: int = 0) -> Work:
        caller = _caller_event(tree)
        return self._submit(lambda: self._broadcast_sync(tree, root, caller))

    def _broadcast_sync(self, tree: Any, root: int,
                        caller: Optional[Tuple[Any, Any]] = None) -> Any:
        if self._world_size == 1:
            if root != 0:
                raise RuntimeError(
                    f"bad broadcast root {root} for world size 1")
            return tree
        leaves, treedef = _flatten(tree)
        if not leaves:
            return tree
        sig = tuple((tuple(l.shape), l.dtype) for l in leaves)
        staging = self._staging_for(sig, out_mult=1)
        d2h = self._write_leaves(leaves, staging, caller)
        t0 = time.perf_counter()
        reply = self._roundtrip(self._op_cmd("broadcast", staging, root=root),
                                self._timeout.total_seconds() + 5.0)
        ring_s = time.perf_counter() - t0
        out = self._read_leaves(staging.out_groups, sig, staging, leaves,
                                caller)
        self._record_op_stats({
            "op": "broadcast",
            "backend": "iso",
            "path": reply.get("path", self._path),
            "bytes": staging.total,
            "d2h_bytes": d2h,
            "ring": ring_s,
            "child_s": reply.get("ring_s", 0.0),
        })
        return _unflatten(treedef, out)

    def barrier(self) -> Work:
        def sync() -> None:
            if self._world_size == 1:
                return
            self._roundtrip({"cmd": "op", "op": "barrier",
                             "timeout_s": self._timeout.total_seconds()},
                            self._timeout.total_seconds() + 5.0)

        return self._submit(sync)


# --------------------------------------------------------------------------
# child: maps the segments, owns the process group, serves ops
# --------------------------------------------------------------------------


class _ChildState:
    def __init__(self) -> None:
        self.xc: Optional[Any] = None  # XLACollectives on the psum path
        self.store: Optional[_native.StoreClient] = None
        self.prefix = ""
        self.rank = -1
        self.world = 0
        self.path = "unconfigured"
        self.opn = 0
        self.segs: Dict[str, Tuple[str, _native.ShmSegment]] = {}
        # the signature repeats every step: keep the native layout call
        # and its JSON off the hot path
        self.layouts: Dict[Any, dict] = {}

    def layout_for(self, counts: List[int], codes: List[int]) -> dict:
        key = (tuple(counts), tuple(codes))
        lay = self.layouts.get(key)
        if lay is None:
            lay = self.layouts[key] = _native.shm_layout(counts, codes, 0)
        return lay

    def attach(self, kind: str, name: str, nbytes: int) -> memoryview:
        cur = self.segs.get(kind)
        if cur is not None and cur[0] == name:
            return cur[1].buffer()
        if cur is not None:
            cur[1].close()
        seg = _native.ShmSegment.attach(name, nbytes)
        self.segs[kind] = (name, seg)
        return seg.buffer()


def _child_configure(state: _ChildState, req: dict) -> dict:
    from .xla_collectives import XLACollectives, _split_store_addr

    connect_timeout = timedelta(seconds=req["connect_timeout_s"])
    t0 = time.perf_counter()
    state.rank = req["rank"]
    state.world = req["world_size"]
    hostport, state.prefix = _split_store_addr(req["store_addr"])
    state.store = _native.StoreClient(hostport, connect_timeout=connect_timeout)
    # The parent's hint is advisory, never acted on alone: the probe and
    # the group's rendezvous are cohort-wide, so rank 0 publishes ONE
    # decision (probe, or the hinted verdict) and every member follows.
    hint = req.get("path_hint")
    decision_key = f"{state.prefix}/iso/cfg/decision"
    if state.rank == 0:
        decision = hint if hint in ("psum", "store") else "probe"
        state.store.set(decision_key, decision.encode(),
                        timeout=connect_timeout)
    else:
        decision = state.store.get(decision_key,
                                   timeout=connect_timeout).decode()
    if decision == "store":
        # no process group: the first op's blocking fetch gives the same
        # failure surface as a cohort barrier would
        state.path = "store"
        return {"ok": True, "path": "store",
                "init_s": time.perf_counter() - t0}
    xc = XLACollectives(timeout=timedelta(seconds=req["timeout_s"]),
                        connect_timeout=connect_timeout, backend="gloo")
    # the child's group rendezvouses on a /child sub-prefix of the store:
    # an in-process plane on the same prefix never cross-talks with it
    xc.configure(req["store_addr"] + "/child", state.rank, state.world)
    init_s = time.perf_counter() - t0
    if decision == "psum":
        state.xc = xc
        state.path = "psum"
        return {"ok": True, "path": "psum", "init_s": init_s}
    # The capability probe: measured, never assumed. Bounded: a peer that
    # dies mid-probe costs one op deadline.
    try:
        probe = torch.ones(8, dtype=torch.float32)
        xc._reduce_flat_([probe], ReduceOp.SUM).wait(
            timeout=timedelta(seconds=req["timeout_s"]))
        if not bool((probe == state.world).all()):
            raise RuntimeError(f"probe sum {probe.tolist()} != {state.world}")
        state.xc = xc
        state.path = "psum"
    except _FuturesTimeout:
        # a timeout is not a capability verdict (a peer died mid-probe):
        # falling back here could split the cohort across paths
        xc.abort()
        raise
    except Exception:  # noqa: BLE001 - no compiled path here
        state.path = "store"
        xc.abort()
    return {"ok": True, "path": state.path, "init_s": init_s}


def _store_key(state: _ChildState, kind: str, slot: Any, rank: int) -> str:
    return f"{state.prefix}/iso/{kind}/{slot}/{rank}"


def _child_store_exchange(state: _ChildState, payload: bytes,
                          timeout_s: float, ranks: List[int]) -> List[bytes]:
    """The store path's exchange: publish this rank's payload under the
    op's slot keys (chunked under the frame cap), then fetch the listed
    ranks'. Every (slot, rank) carries a VERSION key set after the
    chunks: ``get`` waits only for a key to exist, so without it a member
    one op ahead could read a peer's window-old payload from the reused
    slot. Readers poll the version until it names this op, then read the
    chunks once (fresh by the window argument at ``_STORE_SLOTS``)."""
    assert state.store is not None
    slot = state.opn % _STORE_SLOTS
    timeout = timedelta(seconds=timeout_s)
    ver = state.opn.to_bytes(8, "little")
    nchunks = max(1, -(-len(payload) // _STORE_CHUNK))
    for ci in range(nchunks):
        state.store.set(
            _store_key(state, "pay", slot, state.rank) + f"/{ci}",
            payload[ci * _STORE_CHUNK:(ci + 1) * _STORE_CHUNK],
            timeout=timeout)
    state.store.set(_store_key(state, "ver", slot, state.rank), ver,
                    timeout=timeout)
    out = []
    deadline = time.perf_counter() + timeout_s
    for r in ranks:
        if r == state.rank:
            out.append(payload)
            continue
        while True:
            got = state.store.get(_store_key(state, "ver", slot, r),
                                  timeout=timeout)
            if got == ver:
                break
            if time.perf_counter() >= deadline:
                raise TimeoutError(
                    f"isolated store exchange: rank {r} never published op "
                    f"{state.opn} (slot version "
                    f"{int.from_bytes(got, 'little')})")
            time.sleep(0.002)
        parts = [state.store.get(
            _store_key(state, "pay", slot, r) + f"/{ci}", timeout=timeout)
            for ci in range(nchunks)]
        out.append(parts[0] if nchunks == 1 else b"".join(parts))
    return out


def _child_store_barrier(state: _ChildState, timeout_s: float) -> None:
    assert state.store is not None
    key = f"{state.prefix}/iso/bar/{state.opn}"
    deadline = time.perf_counter() + timeout_s
    n = state.store.add(key, 1, timeout=timedelta(seconds=timeout_s))
    while n < state.world:
        if time.perf_counter() >= deadline:
            raise TimeoutError(f"isolated barrier timed out ({n}/{state.world})")
        time.sleep(0.005)
        n = state.store.add(key, 0, timeout=timedelta(seconds=timeout_s))


_REDUCERS = {
    int(ReduceOp.SUM): torch.add,
    int(ReduceOp.PRODUCT): torch.mul,
    int(ReduceOp.MIN): torch.minimum,
    int(ReduceOp.MAX): torch.maximum,
}


def _child_op(state: _ChildState, req: dict) -> dict:
    op = req["op"]
    timeout_s = req["timeout_s"]
    wait = timedelta(seconds=timeout_s)
    t0 = time.perf_counter()
    state.opn += 1
    if op == "barrier":
        if state.path == "psum":
            state.xc.barrier().wait(timeout=wait)
        else:
            _child_store_barrier(state, timeout_s)
        return {"ok": True, "path": state.path,
                "ring_s": time.perf_counter() - t0}

    layout = state.layout_for(req["counts"], req["leaf_codes"])
    in_buf = state.attach("in", req["seg_in"], req["seg_in_bytes"])
    out_buf = state.attach("out", req["seg_out"], req["seg_out_bytes"])
    in_groups = _group_views(in_buf, layout)
    total = layout["total_bytes"]

    if op == "allreduce":
        opcode = req["opcode"]
        divisor = req.get("divisor")
        out_groups = _group_views(out_buf, layout)
        if state.path == "psum":
            for o, i in zip(out_groups, in_groups):
                o.copy_(i)
            state.xc._reduce_flat_(out_groups, ReduceOp(opcode),
                                   divisor).wait(timeout=wait)
        else:
            gathered = _child_store_exchange(
                state, bytes(in_buf[:total]), timeout_s,
                list(range(state.world)))
            reducer = _REDUCERS[opcode]
            for gi, g in enumerate(layout["groups"]):
                dt = _CODE_TO_DTYPE[g["dtype"]]
                acc: Optional[torch.Tensor] = None
                for payload in gathered:  # rank order: deterministic
                    part = _view(payload, dt, g["count"], g["offset"])
                    acc = part.clone() if acc is None else reducer(acc, part)
                assert acc is not None
                if divisor is not None and divisor != 1:
                    _divide_(acc, divisor)
                out_groups[gi].copy_(acc)
    elif op == "allgather":
        if state.path == "psum":
            for gi, g in enumerate(layout["groups"]):
                dt = _CODE_TO_DTYPE[g["dtype"]]
                outs = [_view(out_buf, dt, g["count"], r * total + g["offset"])
                        for r in range(state.world)]
                state.xc._allgather_flat(in_groups[gi], outs).wait(
                    timeout=wait)
        else:
            gathered = _child_store_exchange(
                state, bytes(in_buf[:total]), timeout_s,
                list(range(state.world)))
            for r, payload in enumerate(gathered):
                out_buf[r * total:(r + 1) * total] = payload[:total]
    elif op == "broadcast":
        root = req["root"]
        if state.path == "psum":
            out_groups = _group_views(out_buf, layout)
            for o, i in zip(out_groups, in_groups):
                o.copy_(i)
                state.xc._broadcast_flat_(o, root).wait(timeout=wait)
        else:
            # every member publishes (uniform slot accounting); only the
            # root's payload is read back
            gathered = _child_store_exchange(
                state, bytes(in_buf[:total]), timeout_s, [root])
            out_buf[:total] = gathered[0][:total]
            # a trailing barrier keeps the slots' one-op-lag invariant for
            # mixed op sequences
            _child_store_barrier(state, timeout_s)
    else:
        raise ValueError(f"unknown isolated op {op!r}")
    return {"ok": True, "path": state.path, "ring_s": time.perf_counter() - t0}


def _child_status() -> dict:
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in _FOREIGN_ROOTS)
    return {"ok": True, "pid": os.getpid(), "foreign_modules": foreign,
            "cuda_initialized": bool(torch.cuda.is_initialized())}


def _child_serve(sock: socket.socket) -> None:
    """The child's command loop: one line-JSON reply per command; an
    exception crosses back as ``{"error", "tb"}`` and the loop goes on
    (the parent decides whether it is fatal)."""
    state = _ChildState()
    rfile = sock.makefile("rb")
    sock.sendall(json.dumps({"hello": os.getpid()}).encode() + b"\n")
    while True:
        try:
            line = rfile.readline()
        except OSError:
            break  # the parent closed the channel (a dropped spare, exit)
        if not line:
            break  # parent gone
        try:
            req = json.loads(line)
            cmd = req.get("cmd")
            if cmd == "exit":
                sock.sendall(b'{"ok": true}\n')
                break
            if cmd == "configure":
                reply = _child_configure(state, req)
            elif cmd == "op":
                reply = _child_op(state, req)
            elif cmd == "status":
                reply = _child_status()
            else:
                raise ValueError(f"unknown command {cmd!r}")
        except Exception as e:  # noqa: BLE001 - cross the channel
            import traceback

            reply = {"error": f"{type(e).__name__}: {e}",
                     "tb": traceback.format_exc()}
        try:
            sock.sendall(json.dumps(reply).encode() + b"\n")
        except OSError:
            break


def _child_connect(addr: str) -> None:
    host, _, port = addr.rpartition(":")
    sock = socket.create_connection((host, int(port)), timeout=30)
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        _child_serve(sock)
    finally:
        sock.close()


def _zygote_main() -> None:
    """The fork server (see _Zygote): single-threaded and without a CUDA
    context, since forking a multithreaded or CUDA-initialised process
    inherits lock state a child cannot use; both are checked at
    start. It keeps ONE pre-forked spare parked on a pipe: activation is
    a pipe write, and the replacement forks off the requester's path."""
    import torch.distributed  # noqa: F401 - the child's group, import-warm

    from . import xla_collectives  # noqa: F401

    _native._lib._load()  # the control plane library, mapped once
    if threading.active_count() != 1:
        raise RuntimeError("iso zygote must stay single-threaded to fork "
                           "safely; an import started a thread")
    if torch.cuda.is_initialized():
        raise RuntimeError("iso zygote must not initialise CUDA: a fork of "
                           "it would be unusable")

    def fork_spare() -> Tuple[int, int]:
        """Forks a parked child; returns (pid, activation pipe's write
        end). The spare reads its pipe until a request line arrives, or
        exits on EOF (the zygote died before activating it)."""
        r, w = os.pipe()
        pid = os.fork()
        if pid == 0:
            os.close(w)
            try:
                # fault the activation path's pages in while parked (fork
                # is copy-on-write)
                json.loads('{"warm": 1}')
                socket.socket().close()
                data = b""
                while not data.endswith(b"\n"):
                    chunk = os.read(r, 1 << 16)
                    if not chunk:
                        os._exit(0)  # never activated
                    data += chunk
                os.close(r)
                req = json.loads(data)
                devnull = os.open(os.devnull, os.O_RDONLY)
                os.dup2(devnull, 0)
                os.dup2(2, 1)  # keep the protocol's stdout clean
                env = req.get("env")
                if env is not None:
                    _apply_child_env(env)
                _child_connect(req["connect"])
                os._exit(0)
            except SystemExit as e:
                os._exit(int(e.code or 0))
            except BaseException:
                import traceback

                traceback.print_exc()
                os._exit(1)
        os.close(r)
        return pid, w

    spare_pid, spare_w = fork_spare()
    print(json.dumps({"ready": True}), flush=True)
    # spares ride the reap loop too: one that dies unactivated is waited
    # for and replaced
    children: Dict[int, bool] = {spare_pid: True}
    while True:
        ready, _, _ = select.select([sys.stdin], [], [], 0.1)
        if ready:
            line = sys.stdin.readline()
            if not line:
                break  # parent gone; orphans are its to kill
            req = json.loads(line)
            payload = (json.dumps(req) + "\n").encode()
            delivered = False
            for _attempt in range(2):
                try:
                    os.write(spare_w, payload)
                    os.close(spare_w)
                    delivered = True
                    break
                except OSError:
                    # the spare died unactivated: replace it, retry once
                    try:
                        os.close(spare_w)
                    except OSError:
                        pass
                    spare_pid, spare_w = fork_spare()
                    children[spare_pid] = True
            if delivered:
                print(json.dumps({"pid": spare_pid}), flush=True)
                spare_pid, spare_w = fork_spare()
                children[spare_pid] = True
            else:
                # never report a spare that got no connect payload
                print(json.dumps({"spawn_error":
                                  "spare died unactivated twice"}),
                      flush=True)
        for pid in list(children):
            wpid, status = os.waitpid(pid, os.WNOHANG)
            if wpid:
                del children[pid]
                print(json.dumps({"exit": wpid,
                                  "rc": os.waitstatus_to_exitcode(status)}),
                      flush=True)


def main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--zygote":
        _zygote_main()
    elif len(argv) == 2 and argv[0] == "--child":
        _child_connect(argv[1])
    else:
        raise SystemExit("usage: python -m torchft_tpu_torch.isolated_xla "
                         "--zygote | --child HOST:PORT")


if __name__ == "__main__":
    main()

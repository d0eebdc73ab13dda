"""The deterministic chaos plane.

Every training step is a transaction: an error anywhere latches, the
commit vote discards the step, and the fleet heals. This module makes
faults first-class, so that invariant can be exercised and replayed
from one seed:

- :class:`FaultPlan` is a declarative seeded schedule (*at attempted
  step N, inject fault F at seam S on member M*), drawn from ``(seed,
  config)`` by :meth:`FaultPlan.random` and serialised as JSON, byte for
  byte the JAX package's plan for the same arguments, so a failing
  schedule reproduces from the ``(seed, plan)`` a failure prints.
- :class:`ChaosInjector` drives a plan in one process: native seams
  (``ring_send``/``ring_hdr``/``net_send``/``shm_ring``) arm one-shot
  rules in the port's native fault engine each step; Python seams
  (``store``/``heal``/``child``/``shm``) go to the handlers registered
  for them.
- Seam injectors: :class:`FaultyStoreClient` (drop, delay, stale read),
  :class:`HealFaultProxy` (truncated body, reset, slow-loris, 5xx,
  blackhole, bit flip; in front of a
  :class:`~torchft_tpu_torch.checkpointing.CheckpointServer`),
  :func:`kill_process` / :class:`ProcessStall` (SIGKILL and SIGSTOP),
  :func:`tear_shm`, and the subprocess hosts :class:`RootProcess` and
  :class:`PublisherProcess`.

The seeded hash (:func:`splitmix64`) is the native engine's mixer, so
Python- and native-side decisions derive from one stream.
"""

from __future__ import annotations

import http.server
import json
import os
import signal
import socket
import socketserver
import threading
import time
import urllib.request
from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import _native

_MASK = (1 << 64) - 1

# Seams a plan may name. The native engine owns the first group; the
# rest are realized Python-side by the injectors in this module.
NATIVE_SEAMS = ("ring_send", "ring_hdr", "net_send", "shm_ring", "wal_write")
PYTHON_SEAMS = ("store", "heal", "child", "shm", "lighthouse", "root",
                "serving")
SEAMS = NATIVE_SEAMS + PYTHON_SEAMS

# Kinds per seam (what a random plan may draw). Native ring kinds map
# 1:1 onto native/src/fault.h; Python seams define their own vocabulary.
SEAM_KINDS: Dict[str, Tuple[str, ...]] = {
    "ring_send": ("drop", "delay", "truncate", "duplicate", "bit_flip",
                  "partition"),
    "ring_hdr": ("bit_flip", "drop"),
    # The host tier's shared-memory rings: drop = drop-doorbell (every publish of the op
    # silently vanishes — an asymmetric partition; the consumer stalls
    # to its op deadline), bit_flip = stale-payload (a replayed frame
    # sequence, detected as WireCorruption), truncate = torn-segment
    # (half a frame + poisoned ring magic).
    "shm_ring": ("drop", "delay", "truncate", "bit_flip"),
    "net_send": ("drop", "delay", "truncate", "bit_flip"),
    # The root lighthouse's write-ahead quorum log: truncate = crash mid-append (half a record on disk — recovery must
    # detect + drop the torn tail), drop = crash before any byte lands,
    # delay = slow disk. Both crash kinds kill the log; the root then
    # refuses NEW quorum promises (frozen beats regressed) until restart.
    "wal_write": ("truncate", "drop", "delay"),
    "store": ("drop", "delay", "stale"),
    "heal": ("truncate_body", "reset_mid_range", "slow_loris", "error_500",
             "blackhole"),
    "child": ("sigkill", "sigstop"),
    "shm": ("tear",),
    "lighthouse": ("stall", "kill"),
    # The ROOT lighthouse process (a RootProcess subprocess): kill =
    # SIGKILL the active root mid-promise, restart = kill + respawn on
    # the same port + WAL dir (the replay path), partition = SIGSTOP for
    # `param` ms then SIGCONT (unreachable-but-alive — the takeover +
    # deposed-primary fencing path).
    "root": ("kill", "restart", "partition"),
    # The weight-distribution serving plane (.serving): kill = SIGKILL
    # the publisher subprocess MID-range (TORCHFT_PS_DRIP_MS throttles
    # the body so the kill reliably lands inside a transfer — the
    # short-body + CRC + nonce ladder must avert the install), restart =
    # kill + respawn on the same port (fresh nonces over reused version
    # numbers: the torn-republish 400 path), partition = cut one relay
    # from its upstream (it keeps serving with honestly growing age_ms),
    # churn = subscriber join/leave storm (lease table pruning under
    # load).
    "serving": ("kill", "restart", "partition", "churn"),
}


def splitmix64(x: int) -> int:
    """The native fault engine's mixer (and its backoff jitter's), so
    Python-side decisions derive from the same stream."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: at attempted step ``step``, inject ``kind``
    at ``seam`` on ``member`` (-1 = any member). ``param`` is the kind's
    knob (delay/stall milliseconds, ...)."""

    step: int
    seam: str
    kind: str
    member: int = -1
    param: int = 0


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, replayable fault schedule. Pure data: the same
    ``(seed, events)`` always realizes the same faults, and
    :meth:`random` derives events deterministically from the seed — so a
    failure message carrying ``(seed, plan_json)`` IS the reproducer."""

    seed: int
    events: Tuple[FaultEvent, ...] = ()

    @classmethod
    def random(
        cls,
        seed: int,
        steps: int,
        members: int,
        seams: Sequence[str] = ("ring_send",),
        events_target: int = 3,
        max_delay_ms: int = 200,
    ) -> "FaultPlan":
        """Draws ~``events_target`` events over ``steps`` attempted steps
        across ``members`` members and the given seams — deterministic in
        every argument. Step 0 is left fault-free (the fleet must form
        once before the storm starts)."""
        if steps < 2:
            raise ValueError("need >= 2 steps (step 0 stays clean)")
        events: List[FaultEvent] = []
        n_draws = max(events_target, 1)
        h = splitmix64(seed)
        for draw in range(n_draws):
            h = splitmix64(h ^ draw)
            step = 1 + (h % (steps - 1))
            h = splitmix64(h)
            seam = seams[h % len(seams)]
            kinds = SEAM_KINDS[seam]
            h = splitmix64(h)
            kind = kinds[h % len(kinds)]
            h = splitmix64(h)
            # net_send has no member identity at the native call site
            # (Socket::send_all passes -1): a targeted member would be a
            # lie in the replay stamp, so the plan says "any" honestly.
            member = (
                -1
                if seam == "net_send"
                else (h % members if members > 0 else -1)
            )
            h = splitmix64(h)
            param = (h % max_delay_ms) + 1 if kind in ("delay",) else 0
            if kind in ("sigstop", "stall", "partition"):
                param = 300 + (h % 700)  # ms stopped before SIGCONT
            events.append(FaultEvent(step, seam, kind, member, param))
        events.sort(key=lambda e: (e.step, e.seam, e.kind, e.member))
        return cls(seed=seed, events=tuple(events))

    def events_at(self, step: int, member: Optional[int] = None) -> List[FaultEvent]:
        return [
            e
            for e in self.events
            if e.step == step
            and (member is None or e.member < 0 or e.member == member)
        ]

    def native_rules(self, step: int) -> List[dict]:
        """The native fault-engine rules for this step's native-seam
        events: one-shot (max_fires=1), always-fire (permille=1000) —
        the step axis is driven by the injector's arm/disarm cadence, the
        frame hit is the first matching send of the step."""
        rules = []
        for e in self.events_at(step):
            if e.seam not in NATIVE_SEAMS:
                continue
            rules.append(
                {
                    "seam": e.seam,
                    "kind": e.kind,
                    # net_send call sites carry no member identity, so a
                    # targeted member would silently mean "any" in the
                    # engine; ship the honest -1 instead.
                    "member": -1 if e.seam == "net_send" else e.member,
                    "permille": 1000,
                    "max_fires": 1,
                    "param": e.param,
                }
            )
        return rules

    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed, "events": [asdict(e) for e in self.events]}
        )

    @classmethod
    def from_json(cls, raw: str) -> "FaultPlan":
        d = json.loads(raw)
        return cls(
            seed=int(d["seed"]),
            events=tuple(FaultEvent(**e) for e in d.get("events", [])),
        )

    def fingerprint(self) -> dict:
        """The replay stamp a run's record carries (``fault_plan`` key):
        the seed and the plan, enough to replay it byte for byte."""
        return {
            "seed": self.seed,
            "n_events": len(self.events),
            "plan": self.to_json(),
        }


class ChaosInjector:
    """Drives one :class:`FaultPlan` in one process.

    Call :meth:`begin_step` at the top of every attempted step: native
    rules for that step's native-seam events are armed (one-shot), and
    each Python-seam event is dispatched to the handler registered for
    its seam via :meth:`on`. :meth:`finish` disarms and returns the
    cumulative native injection stats — the harness's injected-fault
    ledger."""

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self._handlers: Dict[str, Callable[[FaultEvent], None]] = {}
        self._python_fired: List[dict] = []

    def on(self, seam: str, handler: Callable[[FaultEvent], None]) -> "ChaosInjector":
        if seam not in PYTHON_SEAMS:
            raise ValueError(f"{seam!r} is not a Python-side seam")
        self._handlers[seam] = handler
        return self

    def begin_step(self, step: int, member: Optional[int] = None) -> None:
        rules = self.plan.native_rules(step)
        # (Re-)arming replaces the rule set; stats accumulate across
        # re-arms. An empty step disarms — a clean step costs the ring
        # its one relaxed load per frame, nothing more.
        _native.fault_arm({"seed": self.plan.seed, "rules": rules})
        for e in self.plan.events_at(step, member):
            if e.seam in NATIVE_SEAMS:
                continue
            handler = self._handlers.get(e.seam)
            if handler is not None:
                handler(e)
                self._python_fired.append(asdict(e))

    def finish(self) -> dict:
        stats = _native.fault_stats()
        _native.fault_disarm()
        stats["python_fired"] = list(self._python_fired)
        return stats


# -- Python seam injectors ---------------------------------------------------


class FaultyStoreClient:
    """A :class:`~torchft_tpu_torch._native.StoreClient` wrapper realizing the
    ``store`` seam: per-op seeded decisions to DROP (raise a timeout, the
    client-visible face of a flaky KV service), DELAY, or serve a STALE
    read (the last value this wrapper saw for the key — a lagging
    replica). Deterministic in ``(seed, op index)``."""

    def __init__(
        self,
        inner: Any,
        seed: int,
        drop_permille: int = 0,
        delay_permille: int = 0,
        stale_permille: int = 0,
        delay_ms: int = 100,
    ) -> None:
        self._inner = inner
        self._seed = seed
        self._drop = drop_permille
        self._delay = delay_permille
        self._stale = stale_permille
        self._delay_ms = delay_ms
        self._op = 0
        self._cache: Dict[str, bytes] = {}
        self.fired: List[str] = []

    def _decide(self) -> Optional[str]:
        h = splitmix64(self._seed ^ (self._op * 0xC2B2AE3D))
        self._op += 1
        gate = h % 1000
        if gate < self._drop:
            return "drop"
        if gate < self._drop + self._delay:
            return "delay"
        if gate < self._drop + self._delay + self._stale:
            return "stale"
        return None

    def _apply(self, op: str) -> Optional[str]:
        verdict = self._decide()
        if verdict == "drop":
            self.fired.append(f"{op}:drop")
            raise TimeoutError(f"chaos injected: store {op} dropped")
        if verdict == "delay":
            self.fired.append(f"{op}:delay")
            time.sleep(self._delay_ms / 1e3)
            return None
        return verdict

    def set(self, key: str, value: Any, **kw: Any) -> None:
        self._apply("set")
        self._inner.set(key, value, **kw)
        self._cache[key] = value if isinstance(value, bytes) else str(value).encode()

    def get(self, key: str, **kw: Any) -> bytes:
        verdict = self._apply("get")
        if verdict == "stale" and key in self._cache:
            self.fired.append("get:stale")
            return self._cache[key]
        out = self._inner.get(key, **kw)
        self._cache[key] = out
        return out

    def add(self, key: str, delta: int, **kw: Any) -> int:
        self._apply("add")
        return self._inner.add(key, delta, **kw)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)


class HealFaultProxy:
    """An HTTP proxy in front of a checkpoint donor realizing the
    ``heal`` seam. ``mode`` (mutable between fetches) selects the fault:

    - ``"truncate_body"``: correct headers, half the body, then close —
      the torn-response case the receiver must detect and fall back from
      without double-charging its timeout budget.
    - ``"reset_mid_range"``: connection reset halfway through the body.
    - ``"slow_loris"``: trickle the body a few bytes per second (the
      receiver's deadline, not patience, must end it).
    - ``"error_500"``: a flaky-donor 5xx.
    - ``"blackhole"``: accept, read the request, never answer.
    - ``"bit_flip"``: forward the body with ONE byte corrupted while
      preserving the donor's integrity header — the receiver's CRC
      check, not luck, must catch it (the zero-silent-commits contract
      applied to heal traffic).
    - ``None``: transparent pass-through.

    ``only_paths`` (substring match) limits faults to matching request
    paths — e.g. fault ``/stream/`` ranges while leaving the layout
    fetch clean. ``max_faults`` bounds how many requests are faulted
    (later ones pass through, so fallbacks can succeed)."""

    def __init__(
        self,
        upstream: str,
        mode: Optional[str] = None,
        only_paths: Sequence[str] = (),
        max_faults: int = 1 << 30,
    ) -> None:
        self.upstream = upstream.rstrip("/")
        self.mode = mode
        self.only_paths = tuple(only_paths)
        self.max_faults = max_faults
        self.faults_fired = 0
        self.requests: List[str] = []
        proxy = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_GET(self) -> None:  # noqa: N802 - stdlib naming
                proxy.requests.append(self.path)
                mode = proxy.mode
                if (
                    mode is not None
                    and proxy.faults_fired < proxy.max_faults
                    and (
                        not proxy.only_paths
                        or any(p in self.path for p in proxy.only_paths)
                    )
                ):
                    proxy.faults_fired += 1
                    if mode == "blackhole":
                        # hold the socket open, never answer; the client's
                        # timeout is the only way out
                        time.sleep(3600)
                        return
                    if mode == "error_500":
                        self.send_error(500, "chaos injected: donor error")
                        return
                    try:
                        with urllib.request.urlopen(
                            proxy.upstream + self.path, timeout=30
                        ) as resp:
                            body = resp.read()
                            upstream_headers = dict(resp.headers.items())
                    except Exception:
                        self.send_error(502, "upstream failed")
                        return
                    if mode == "bit_flip":
                        corrupted = bytearray(body)
                        if corrupted:
                            h = splitmix64(len(body) ^ 0xC0FFEE)
                            corrupted[h % len(corrupted)] ^= 1 << (h % 8)
                        self.send_response(200)
                        self.send_header("Content-Length", str(len(corrupted)))
                        crc = upstream_headers.get("X-Tft-Crc32c") or (
                            upstream_headers.get("X-TFT-Crc32c")
                        )
                        if crc:
                            self.send_header("X-TFT-Crc32c", crc)
                        self.end_headers()
                        self.wfile.write(bytes(corrupted))
                        return
                    if mode == "truncate_body":
                        self.send_response(200)
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body[: len(body) // 2])
                        self.wfile.flush()
                        # close underneath the declared length: the
                        # receiver sees a short read, not a clean EOF
                        self.connection.close()
                        return
                    if mode == "reset_mid_range":
                        self.send_response(200)
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body[: max(1, len(body) // 2)])
                        self.wfile.flush()
                        # RST, not FIN: SO_LINGER 0 + close
                        import struct

                        self.connection.setsockopt(
                            socket.SOL_SOCKET,
                            socket.SO_LINGER,
                            struct.pack("ii", 1, 0),
                        )
                        self.connection.close()
                        return
                    if mode == "slow_loris":
                        self.send_response(200)
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        for i in range(0, len(body), 16):
                            self.wfile.write(body[i : i + 16])
                            self.wfile.flush()
                            time.sleep(0.5)
                        return
                # transparent pass-through (headers included — the CRC
                # header must survive the proxy)
                try:
                    with urllib.request.urlopen(
                        proxy.upstream + self.path, timeout=30
                    ) as resp:
                        body = resp.read()
                        self.send_response(resp.status)
                        for k, v in resp.headers.items():
                            if k.lower() in ("content-length", "x-tft-crc32c"):
                                self.send_header(k, v)
                        if "Content-Length" not in resp.headers:
                            self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                except urllib.error.HTTPError as e:
                    self.send_error(e.code, str(e.reason))
                except Exception:
                    self.send_error(502, "upstream failed")

            def log_message(self, fmt: str, *args: Any) -> None:
                pass

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Server(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="heal_chaos"
        )
        self._thread.start()

    def address(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def kill_process(pid: int) -> None:
    """SIGKILL — the classic clean-death fault (child seam ``sigkill``)."""
    try:
        os.kill(pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


class ProcessStall:
    """SIGSTOP a process for ``duration_s``, then SIGCONT — the
    stalled-not-dead fault (child seam ``sigstop``, lighthouse seam
    ``stall``): the victim is alive to every liveness poll while doing
    nothing, the long-tail failure mode clean deaths never exercise.
    ``start()`` returns immediately; ``join()`` waits for the CONT."""

    def __init__(self, pid: int, duration_s: float) -> None:
        self.pid = pid
        self.duration_s = duration_s
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ProcessStall":
        try:
            os.kill(self.pid, signal.SIGSTOP)
        except (ProcessLookupError, PermissionError):
            return self

        def cont() -> None:
            time.sleep(self.duration_s)
            try:
                os.kill(self.pid, signal.SIGCONT)
            except (ProcessLookupError, PermissionError):
                pass

        self._thread = threading.Thread(target=cont, daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)


class RootProcess:
    """A root lighthouse hosted in a SUBPROCESS — the ``root`` seam's
    substrate. In-process lighthouses cannot be SIGKILLed without taking
    the harness down with them; this wrapper runs ``python -m
    torchft_tpu_torch.lighthouse`` on a FIXED port (so managers' endpoint lists
    and a restart's address both survive the kill) with an optional WAL
    dir, peer list and standby role, and exposes the three root
    injectors:

    - :meth:`kill` — SIGKILL (the mid-promise crash; with a WAL dir the
      next :meth:`restart` replays to the pre-crash watermark).
    - :meth:`restart` — kill + respawn with the same port/WAL/peers (the
      recovery path; a deposed primary fences itself at startup when a
      peer took over meanwhile).
    - :meth:`partition` — SIGSTOP for ``duration_s`` then SIGCONT: the
      root is unreachable but ALIVE, the takeover + stall-self-fence
      path clean deaths never exercise.
    """

    def __init__(
        self,
        port: int,
        wal_dir: str = "",
        peers: str = "",
        standby: bool = False,
        takeover_ms: int = 0,
        min_replicas: int = 1,
        join_timeout_ms: int = 200,
        heartbeat_timeout_ms: int = 5000,
        extra_env: Optional[Dict[str, str]] = None,
    ) -> None:
        self.port = port
        self.wal_dir = wal_dir
        self.peers = peers
        self.standby = standby
        self.takeover_ms = takeover_ms
        self.min_replicas = min_replicas
        self.join_timeout_ms = join_timeout_ms
        self.heartbeat_timeout_ms = heartbeat_timeout_ms
        self.extra_env = dict(extra_env or {})
        self.proc: Optional[Any] = None
        self.restarts = 0
        self.spawn()

    def address(self) -> str:
        return f"http://localhost:{self.port}"

    @property
    def pid(self) -> Optional[int]:
        return None if self.proc is None else self.proc.pid

    def _argv(self) -> List[str]:
        import sys

        argv = [
            sys.executable,
            "-m",
            "torchft_tpu_torch.lighthouse",
            "--role",
            "root",
            "--bind",
            f"[::]:{self.port}",
            "--min_replicas",
            str(self.min_replicas),
            "--join_timeout_ms",
            str(self.join_timeout_ms),
            "--heartbeat_timeout_ms",
            str(self.heartbeat_timeout_ms),
        ]
        if self.wal_dir:
            argv += ["--wal-dir", self.wal_dir]
        if self.peers:
            argv += ["--peers", self.peers]
        if self.standby:
            argv += ["--standby"]
        if self.takeover_ms:
            argv += ["--takeover-ms", str(self.takeover_ms)]
        return argv

    def spawn(self) -> None:
        import subprocess

        env = dict(os.environ)
        # The child resolves `-m torchft_tpu_torch.lighthouse` via
        # PYTHONPATH, not the harness's cwd.
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = repo + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        env.update(self.extra_env)
        self.proc = subprocess.Popen(self._argv(), env=env)

    def status(self, timeout: float = 2.0) -> Optional[dict]:
        """One /status.json read, or None while unreachable."""
        try:
            with urllib.request.urlopen(
                self.address() + "/status.json", timeout=timeout
            ) as r:
                return json.loads(r.read().decode("utf-8"))
        except Exception:  # noqa: BLE001 - down/partitioned is the point
            return None

    def wait_serving(self, deadline_s: float = 20.0) -> dict:
        """Blocks until /status.json answers (any role); returns it."""
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            st = self.status()
            if st is not None:
                return st
            time.sleep(0.05)
        raise TimeoutError(f"root on port {self.port} never served status")

    def kill(self) -> None:
        """SIGKILL — the root seam's clean-crash fault."""
        if self.proc is not None and self.proc.poll() is None:
            kill_process(self.proc.pid)
            self.proc.wait(timeout=10)

    def restart(self) -> None:
        """kill + respawn on the same port/WAL/peers: the replay path."""
        self.kill()
        self.restarts += 1
        self.spawn()

    def partition(self, duration_s: float) -> ProcessStall:
        """SIGSTOP for ``duration_s`` then SIGCONT (started; join() the
        returned stall to wait for the CONT)."""
        assert self.proc is not None
        return ProcessStall(self.proc.pid, duration_s).start()

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except Exception:  # noqa: BLE001
                self.proc.kill()


class PublisherProcess:
    """A demo weight publisher hosted in a SUBPROCESS — the ``serving``
    seam's substrate (``python -m torchft_tpu_torch.serving`` on a FIXED port,
    so relays keep dialing the same upstream across kills). The chaos
    point: ``TORCHFT_PS_DRIP_MS`` makes the publisher stream range
    bodies in 64 KiB dribbles, so :meth:`kill` reliably lands MID-range
    — the subscriber-side short-body/CRC ladder must avert the install,
    never tear it. :meth:`restart` respawns on the same port with a
    FRESH version history (new nonces over reused version numbers),
    which is exactly the torn-republish case the 400-nonce contract and
    the downstream regression-resync guard. The publisher's weights
    live on ``device`` (``None``: the card).

    The deterministic ``seed`` means every incarnation publishes the
    same weight trees (:func:`torchft_tpu_torch.serving.demo_params`), so the
    harness can verify any subscriber's installed tree bit-for-bit
    without talking to the (possibly dead) publisher."""

    def __init__(
        self,
        port: int,
        wire: str = "q8",
        leaves: int = 4,
        elems: int = 16384,
        seed: int = 0,
        publish_every_ms: int = 250,
        snapshot_every: int = 4,
        keep: int = 16,
        drip_ms: int = 0,
        extra_env: Optional[Dict[str, str]] = None,
        device: Optional[str] = None,
    ) -> None:
        self.port = port
        self.wire = wire
        self.device = device
        self.leaves = leaves
        self.elems = elems
        self.seed = seed
        self.publish_every_ms = publish_every_ms
        self.snapshot_every = snapshot_every
        self.keep = keep
        self.drip_ms = drip_ms
        self.extra_env = dict(extra_env or {})
        self.proc: Optional[Any] = None
        self.restarts = 0
        self.spawn()

    def address(self) -> str:
        return f"http://[::1]:{self.port}"

    @property
    def pid(self) -> Optional[int]:
        return None if self.proc is None else self.proc.pid

    def _argv(self) -> List[str]:
        import sys

        return [
            sys.executable,
            "-m",
            "torchft_tpu_torch.serving",
            "--port", str(self.port),
            "--wire", self.wire,
            "--leaves", str(self.leaves),
            "--elems", str(self.elems),
            "--seed", str(self.seed),
            "--publish-every-ms", str(self.publish_every_ms),
            "--snapshot-every", str(self.snapshot_every),
            "--keep", str(self.keep),
        ] + (["--device", self.device] if self.device else [])

    def spawn(self) -> None:
        import subprocess

        env = dict(os.environ)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = repo + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        if self.drip_ms > 0:
            env["TORCHFT_PS_DRIP_MS"] = str(self.drip_ms)
        env.update(self.extra_env)
        self.proc = subprocess.Popen(self._argv(), env=env)

    def status(self, timeout: float = 2.0) -> Optional[dict]:
        """One /ps/status read, or None while unreachable."""
        try:
            with urllib.request.urlopen(
                self.address() + "/ps/status", timeout=timeout
            ) as r:
                return json.loads(r.read().decode("utf-8"))
        except Exception:  # noqa: BLE001 - down IS a state here
            return None

    def wait_serving(self, deadline_s: float = 30.0, min_version: int = 0) -> dict:
        """Blocks until /ps/status answers with ``latest >=
        min_version``; returns the status."""
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            st = self.status()
            if st is not None and int(st.get("latest", -1)) >= min_version:
                return st
            time.sleep(0.05)
        raise TimeoutError(
            f"publisher on port {self.port} never reached v{min_version}"
        )

    def kill(self) -> None:
        """SIGKILL — with ``drip_ms`` set, this lands mid-range on any
        in-flight transfer (the serving seam's signature fault)."""
        if self.proc is not None and self.proc.poll() is None:
            kill_process(self.proc.pid)
            self.proc.wait(timeout=10)

    def restart(self) -> None:
        """kill + respawn on the same port: version numbers restart at 0
        under fresh nonces — the torn-republish path."""
        self.kill()
        self.restarts += 1
        self.spawn()

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except Exception:  # noqa: BLE001
                self.proc.kill()


def free_port() -> int:
    """Reserves an ephemeral port and releases it (the usual bind-probe;
    RootProcess needs FIXED ports so kills and restarts keep the
    address). The close-to-spawn window is racy in principle; harness
    fleets allocate their ports up front, back to back, so collisions
    would need an outside writer."""
    s = socket.socket(socket.AF_INET6, socket.SOCK_STREAM)
    try:
        s.bind(("::", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def tear_shm(name: str) -> None:
    """Realizes the ``shm`` seam's ``tear``: unlinks the segment NAME so
    the next attach fails (the torn-segment-on-attach lifecycle fault;
    existing mappings stay valid, exactly like a crashed creator that
    never finished publishing)."""
    try:
        _native.shm_unlink(name)
    except RuntimeError:
        pass


# -- bench artifact stamping -------------------------------------------------


def bench_fault_stamp(plan: Optional[FaultPlan] = None, **bench_fields: Any) -> dict:
    """The ``fault_plan`` key a run's record carries: the seeded schedule
    that produced the run (explicit ``plan``, else the
    ``TORCHFT_CHAOS_SEED`` / ``TORCHFT_CHAOS_PLAN`` variables), plus the
    run's own fault knobs (kill cadence etc.), so an anomaly replays."""
    out: Dict[str, Any] = dict(bench_fields)
    env_plan = os.environ.get("TORCHFT_CHAOS_PLAN")
    env_seed = os.environ.get("TORCHFT_CHAOS_SEED")
    if plan is not None:
        out.update(plan.fingerprint())
    elif env_plan:
        try:
            out.update(FaultPlan.from_json(env_plan).fingerprint())
        except (ValueError, KeyError, json.JSONDecodeError):
            out["plan_parse_error"] = True
            out["plan"] = env_plan
    elif env_seed:
        # Degrade, never raise: the stamp runs when the record is
        # written, the last step of a long run; a typo'd seed must not
        # discard its results.
        try:
            out["seed"] = int(env_seed)
        except ValueError:
            out["seed_parse_error"] = True
            out["seed"] = env_seed
    else:
        out["seed"] = None
    return out

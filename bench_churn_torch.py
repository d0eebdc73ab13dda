"""Churn benchmark on the port: throughput under replica-group kills.

The counterpart of ``bench_churn.py`` for ``torchft_tpu_torch``, function
by function under the same names. It measures the north star of
BASELINE.md: steps/sec with one replica-group kill every ``--kill-every``
steps must stay >= 90% of healthy-state steps/sec. The reference makes
this claim qualitatively ("avoid stop the world training on errors",
reference README.md:46-47) and exercises the recovery flow in tests
(reference torchft/manager.py:470-526); this benchmark puts a number on
it.

Topology: N replica groups as local processes, one real HostCollectives
TCP ring between them, one lighthouse. Group 0, the measurement group,
runs on the card; groups 1..N-1 run on the host CPU with
``CUDA_VISIBLE_DEVICES=""`` (they never create a CUDA context) and are
the churn. Three phases with the same model and config:

  healthy:   all groups train ``--steps`` steps, no faults.
  churn:     a supervisor SIGKILLs one group (rotating over 1..N-1, never
             group 0) each time group 0 commits ``--kill-every`` more
             steps, then restarts it; the restarted process heals from a
             live peer over HTTP.
  churn_hot: (``--hot-spare``) the same kills, restarts by promoting a
             pre-warmed standby (the launcher's --hot-spare policy).

Reported (the ``--out`` JSON + one JSON line on stdout):
  steps_per_sec_healthy / steps_per_sec_churn  (group 0's committed steps)
  ratio  = churn / healthy       (north star: >= 0.90)
  heal_p50_s = median time from SIGKILL to the restarted group's first
               committed step (includes the process restart and the first
               forward/backward; on real deployments each group has its own
               host, so single-host numbers are pessimistic: the restarting
               process competes for this machine's CPUs).

A separate ``--durable`` mode benches the durable checkpoint tier:
per-checkpoint trainer stall of the async sharded zero-copy snapshot vs
the synchronous writer, per-member durable bytes (~1/W), and the cold
no-donor restore split into manifest-read / shard-fetch / reshard / h2d /
compile buckets; its state lives on the card, and the bf16 wire narrows
the optimizer moments there with K3. ``--durable --dryrun`` is the smoke:
it asserts one committed async-snapshot record and one no-donor-restore
record and writes no artifact.

Where it departs from ``bench_churn.py``:

- There is no CPU fallback: without a card and without ``--device cpu``
  it exits 2 naming the missing card. ``--device cpu`` (the CPU
  rehearsal) puts group 0 and the durable state on the CPU too;
  ``--device`` replaces ``--tpu-group0``, and the record's config carries
  ``card_group0`` in place of ``tpu_group0``.
- There is no jit: a worker's ``compiled_t`` is stamped after its first
  forward/backward on its device, its ``backend_t`` after
  ``torch.cuda.init()`` and one launch on the card (nothing on the CPU);
  the durable restore's ``compile_s`` is the first update on the
  restored state, and its ``reshard_s`` / ``h2d_s`` split the rebuild on
  the device (the one upload of the packed buffer, then the views and
  the widening of the moments). JAX's persistent compile cache
  (``TORCHFT_COMPILE_CACHE``) has no counterpart: the port's native
  library and kernels are built once into ``_build/``, by this process
  before any worker or the zygote starts.
- The zygote imports torch and the port and never runs a torch op nor
  touches CUDA, so its forks inherit no thread pool and no CUDA context;
  only CPU groups fork from it, the card group always starts a fresh
  interpreter (started while the zygote warms). CPU groups get
  ``OMP_NUM_THREADS`` = the host's cores over the groups (an inherited
  value wins): a torch CPU pool per group on every core would spin the
  host's cores against each other.
- A group's environment values are set as given (an empty
  ``CUDA_VISIBLE_DEVICES`` hides the card); the JAX tool's "empty means
  unset" rule served ``JAX_PLATFORMS`` and has no use here.
- Results go to ``--out`` only (no file by default); logs go to
  ``.bench_churn_torch_logs/``. A worker on the card also writes its
  kernel launch counts beside its log (``<log>.launches.json``) when it
  ends.

Usage::

    python bench_churn_torch.py --groups 4 --steps 1200 --kill-every 100 \
        --hot-spare --out churn.json
    python bench_churn_torch.py --durable --out durable.json
    python bench_churn_torch.py --dryrun --device cpu   # CPU rehearsal
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.abspath(__file__))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# exit code of a run refused for want of a card
EXIT_NO_CARD = 2


# --------------------------------------------------------------------------
# worker: one replica group
# --------------------------------------------------------------------------


def worker() -> None:
    """Trains the flagship transformer (small config) with the full FT path,
    appending one JSONL record per attempted step (plus one "boot" record
    timestamping the restart->rejoin phases for the heal breakdown, and one
    "heal" record per live recovery carrying the streamed-fetch stats)."""
    t_enter = time.time()
    from torchft_tpu_torch.platform import standby_gate, standby_should_warm

    from datetime import timedelta

    import torch

    import torchft_tpu_torch.models  # noqa: F401 - an import, for setup_t
    from torchft_tpu_torch import HostCollectives, Manager, OptimizerWrapper

    group = int(os.environ["REPLICA_GROUP_ID"])
    num_steps = int(os.environ["NUM_STEPS"])
    log_path = os.environ["BENCH_LOG"]
    device = torch.device(os.environ.get("BENCH_DEVICE", "cuda"))
    t_setup = time.time()  # library imports done

    # Backend acquisition timed on its own: the CUDA context and one
    # launch on the card; nothing on the CPU, whose pool is sized here.
    if device.type == "cuda":
        torch.cuda.init()
        device = torch.device("cuda", torch.cuda.current_device())
        torch.ones(1, device=device).sum().item()
    elif os.environ.get("OMP_NUM_THREADS"):
        torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    t_backend = time.time()

    cfg, batch, state, grad_fn = _model(group, device)
    t_model = time.time()  # params + optimizer state live on the device

    # First forward/backward BEFORE joining the quorum, then hold at the
    # start line until every group is ready (parent touches the go file).
    # Without this the first group up forms a solo quorum and races at
    # world-size-1 speed while peers are still starting, polluting the
    # measured window. Restarted workers find the go file already present
    # and rejoin immediately through the normal heal path.
    _, grads0 = grad_fn(state.params, batch)
    _drain(device)
    # The collectives object exists BEFORE the gate (no network until
    # configure), so promotion pays neither its thread start nor — after
    # the warm-up below — the first optimizer update's or the packer's
    # allocations: promotion is quorum join + weight fetch only.
    collectives = HostCollectives(timeout=timedelta(seconds=30))
    is_standby = bool(os.environ.get("TORCHFT_STANDBY_FILE"))
    if is_standby and standby_should_warm():
        # Truly-warm STANDBY discipline (TORCHFT_STANDBY_WARM): run the
        # optimizer update and the ring pack once ahead of time, so every
        # piece of device code the first post-promotion step needs is
        # loaded. Cold restarts skip this on purpose: for them every
        # pre-gate second delays the rejoin.
        state.warm(grads0)
        collectives.prewarm(grads0)
    _drain(device)
    t_compiled = time.time()
    # Hot-spare standbys park HERE, fully warmed, until promoted; for
    # them activated_t is the promotion instant, for cold starts it
    # coincides with the warm-up's end.
    standby_gate()
    t_activated = time.time()

    # Manager BEFORE the start line: heartbeats flow while the groups
    # gather at the go-gate, so the first quorum's join gate sees every
    # group as healthy and holds the door for all of them — otherwise the
    # first group to request forms an instant solo quorum (it is the only
    # HEARTBEATING replica at that moment) and membership flaps from
    # there.
    manager = Manager(
        collectives=collectives,
        load_state_dict=state.load_state_dict,
        state_dict=state.state_dict,
        min_replica_size=1,
        heartbeat_interval=timedelta(milliseconds=50),
        replica_id=f"bench_{group}",
        device=device,
    )
    optimizer = OptimizerWrapper(manager, state)
    transport = manager.checkpoint_transport()

    go_path = os.environ["BENCH_GO"]
    open(log_path + ".ready", "w").close()
    while not os.path.exists(go_path):
        time.sleep(0.05)

    with open(log_path, "a", buffering=1) as log:
        # Boot record first: the parent joins it with its kill/spawn
        # timestamps to break heal latency into respawn / import / setup /
        # backend_init / mesh / compile / rendezvous phases.
        log.write(
            json.dumps(
                {
                    "boot": {
                        "spawn_t": float(os.environ.get("BENCH_SPAWN_T", 0)),
                        "enter_t": t_enter,
                        "setup_t": t_setup,
                        "backend_t": t_backend,
                        "model_t": t_model,
                        "compiled_t": t_compiled,
                        "activated_t": t_activated,
                        "manager_t": time.time(),
                    }
                }
            )
            + "\n"
        )
        last_heal_stats = None
        while manager.current_step() < num_steps:
            t0 = time.perf_counter()
            optimizer.zero_grad()
            t1 = time.perf_counter()
            loss, grads = grad_fn(state.params, batch)
            _drain(device)
            t2 = time.perf_counter()
            avg = manager.allreduce(grads).wait()
            t3 = time.perf_counter()
            committed = optimizer.step(avg)
            t4 = time.perf_counter()
            log.write(
                json.dumps(
                    {
                        "t": time.time(),
                        "step": manager.current_step(),
                        "committed": bool(committed),
                        "participants": manager.num_participants(),
                        "ms": {
                            "quorum_start": round((t1 - t0) * 1e3, 1),
                            "grad": round((t2 - t1) * 1e3, 1),
                            "allreduce": round((t3 - t2) * 1e3, 1),
                            "commit": round((t4 - t3) * 1e3, 1),
                        },
                    }
                )
                + "\n"
            )
            # One "heal" record per live recovery: the transport's fetch
            # stats (stream path, wire, fetch/h2d seconds) joined by the
            # parent into the heal breakdown.
            stats = getattr(transport, "last_fetch_stats", None)
            if stats is not None and stats is not last_heal_stats:
                last_heal_stats = stats
                log.write(
                    json.dumps({"heal": {"t": time.time(), **stats}}) + "\n"
                )
    manager.shutdown()
    collectives.shutdown()
    if device.type == "cuda":
        # the kernels this group launched (K3 when it served a heal on the
        # bf16 wire), for a caller that holds the card's launches
        from torchft_tpu_torch.ops import launch_counts

        with open(log_path + ".launches.json", "w") as f:
            json.dump(dict(launch_counts), f)


def _model(group: int, device, params=None, dtype=None) -> tuple:
    """A worker's ``(cfg, batch, state, grad_fn)``: the tool's own LM
    (vocab 2048, d_model 128, 4 heads, 2 layers, d_ff 256, S 64; its
    matmuls in ``dtype``, default the LM's bf16), group
    ``group``'s batch of 4 drawn from ``numpy.random.default_rng(group)``
    as int64 tokens on ``device``, an ``FTTrainState`` over ``params``
    (default: the port's ``init_params`` seed 0, the same in every group)
    with AdamW at 1e-3 (optax's defaults), and ``grad_fn(params, tokens)
    -> (loss, grads)``, ``jax.value_and_grad`` of the LM's loss."""
    import dataclasses

    import numpy as np
    import torch

    from torchft_tpu_torch import AdamW, FTTrainState
    from torchft_tpu_torch._tree import flatten, unflatten
    from torchft_tpu_torch.models import TransformerConfig, init_params, loss_fn

    cfg = TransformerConfig(
        vocab_size=2048, d_model=128, n_heads=4, n_layers=2, d_ff=256,
        max_seq_len=64,
    )
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    batch_size, seq_len = 4, 64
    rng = np.random.default_rng(group)
    batch = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(batch_size, seq_len),
                     dtype=np.int32).astype(np.int64)
    ).to(device)
    if params is None:
        params = init_params(cfg, 0, device)
    for leaf in flatten(params)[0]:
        leaf.requires_grad_(True)  # the step differentiates the state's own
    state = FTTrainState(params, AdamW(1e-3))

    def grad_fn(params, tokens):
        leaves, treedef = flatten(params)
        loss = loss_fn(cfg, params, tokens)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), unflatten(treedef, list(grads))

    return cfg, batch, state, grad_fn


def _drain(device) -> None:
    """Waits for the card's queued work (``jax.block_until_ready``)."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


# --------------------------------------------------------------------------
# zygote: import-warm respawn server
# --------------------------------------------------------------------------


def zygote() -> None:
    """Import-warm respawn server (``TORCHFT_ZYGOTE=0`` disables): pays
    the worker's Python import bill ONCE, then forks a ready-to-run
    worker per request. A cold restart's dominant cost on this bench is
    re-importing torch and the port under survivor contention (the
    breakdown's ``import`` / ``setup`` buckets); priority levers can't fix
    it where nice is unenforced (gVisor), but not re-doing the work can.
    The zygote stays SINGLE-THREADED, runs no torch op and never touches
    CUDA (a forked child that inherits an OpenMP pool or a CUDA context
    hangs); each forked child sizes its own CPU pool, so the breakdown's
    backend_init / mesh / compile phases stay honest per restart and only
    the pure re-import cost disappears. It builds nothing: the parent
    built the native library before starting it.

    Protocol (line-JSON): parent writes ``{"env": {...full child env},
    "nice": N}`` on stdin; zygote forks, answers ``{"pid": P}``, and
    reports reaped children as ``{"exit": P, "rc": RC}`` (kills surface
    as negative signal codes, matching subprocess semantics)."""
    import select

    import numpy  # noqa: F401
    import torch  # noqa: F401

    import torchft_tpu_torch  # noqa: F401
    import torchft_tpu_torch.checkpointing  # noqa: F401
    import torchft_tpu_torch.collectives  # noqa: F401
    import torchft_tpu_torch.manager  # noqa: F401
    import torchft_tpu_torch.models  # noqa: F401
    import torchft_tpu_torch.optim  # noqa: F401
    import torchft_tpu_torch.platform  # noqa: F401
    import torchft_tpu_torch.train_state  # noqa: F401

    assert threading.active_count() == 1, (
        "zygote must stay single-threaded to fork safely; an import "
        "started a thread"
    )
    print(json.dumps({"ready": True}), flush=True)
    children: Dict[int, bool] = {}
    while True:
        ready, _, _ = select.select([sys.stdin], [], [], 0.1)
        if ready:
            line = sys.stdin.readline()
            if not line:
                break  # parent is gone; any orphans are its to kill
            req = json.loads(line)
            pid = os.fork()
            if pid == 0:
                # -- child: become the worker --
                try:
                    devnull = os.open(os.devnull, os.O_RDONLY)
                    os.dup2(devnull, 0)  # stdin is the PROTOCOL pipe
                    os.dup2(2, 1)  # keep the protocol stdout clean too
                    os.environ.clear()
                    os.environ.update(req["env"])
                    if req.get("nice"):
                        try:
                            os.nice(int(req["nice"]))
                        except OSError:
                            pass
                    worker()
                    os._exit(0)
                except SystemExit as e:
                    os._exit(int(e.code or 0))
                except BaseException:
                    import traceback

                    traceback.print_exc()
                    os._exit(1)
            children[pid] = True
            print(json.dumps({"pid": pid}), flush=True)
        for pid in list(children):
            wpid, status = os.waitpid(pid, os.WNOHANG)
            if wpid:
                del children[pid]
                print(
                    json.dumps(
                        {"exit": wpid,
                         "rc": os.waitstatus_to_exitcode(status)}
                    ),
                    flush=True,
                )


class _ZygoteProc:
    """Popen-shaped handle for a zygote-forked worker (the supervisor
    signals it directly by pid; exit codes arrive via the zygote's
    reaper events)."""

    def __init__(self, zyg: "_Zygote", pid: int) -> None:
        self._zyg = zyg
        self.pid = pid

    def poll(self) -> Optional[int]:
        rc = self._zyg.exit_codes.get(self.pid)
        if rc is not None:
            return rc
        if not self._zyg.alive():
            # Zygote gone (phase teardown): fall back to a liveness
            # probe so the final wait loop can't spin on a dead child.
            try:
                os.kill(self.pid, 0)
            except ProcessLookupError:
                return -9
        return None

    def send_signal(self, sig: int) -> None:
        try:
            os.kill(self.pid, sig)
        except ProcessLookupError:
            pass

    def kill(self) -> None:
        self.send_signal(signal.SIGKILL)

    def terminate(self) -> None:
        self.send_signal(signal.SIGTERM)

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = time.time() + (timeout if timeout is not None else 3600)
        while True:
            rc = self.poll()
            if rc is not None:
                return rc
            if time.time() >= deadline:
                raise subprocess.TimeoutExpired("zygote-child", timeout)
            time.sleep(0.05)


class _Zygote:
    """Parent-side handle: one import-warm respawn server per phase."""

    def __init__(self, base_env: Dict[str, str]) -> None:
        """Starts the zygote; :meth:`wait_ready` blocks until it is warm."""
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--zygote"],
            env=base_env,
            cwd=REPO,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            text=True,
            bufsize=1,
        )
        self.exit_codes: Dict[int, int] = {}
        self._responses: "queue.Queue[dict]" = queue.Queue()
        self._lock = threading.Lock()
        threading.Thread(
            target=self._read, daemon=True, name="zygote_reader"
        ).start()

    def wait_ready(self) -> None:
        msg = self._responses.get(timeout=120)
        if not msg.get("ready"):
            raise RuntimeError(f"zygote failed to warm: {msg}")

    def _read(self) -> None:
        try:
            for line in self.proc.stdout:
                msg = json.loads(line)
                if "exit" in msg:
                    self.exit_codes[msg["exit"]] = msg["rc"]
                else:
                    if "pid" in msg:
                        # The kernel recycles pids: clear a stale exit
                        # code from a previous worker IN PIPE ORDER, so
                        # a fresh child never reads as already-dead (and
                        # its own exit, which can only arrive later on
                        # this pipe, is never erased).
                        self.exit_codes.pop(msg["pid"], None)
                    self._responses.put(msg)
        except Exception:
            pass  # zygote died; spawn() falls back to classic Popen
        # a zygote that ends before it is ready must not leave the
        # constructor waiting out its whole timeout
        self._responses.put({"ready": False, "rc": self.proc.poll()})

    def spawn(self, env: Dict[str, str], nice: int = 0) -> _ZygoteProc:
        with self._lock:
            self.proc.stdin.write(
                json.dumps({"env": env, "nice": nice}) + "\n"
            )
            self.proc.stdin.flush()
            msg = self._responses.get(timeout=60)
        return _ZygoteProc(self, msg["pid"])

    def alive(self) -> bool:
        return self.proc.poll() is None

    def shutdown(self) -> None:
        try:
            self.proc.kill()
            self.proc.wait()
        except Exception:
            pass


# --------------------------------------------------------------------------
# parent: orchestration + measurement
# --------------------------------------------------------------------------


class _Group:
    def __init__(
        self, gid: int, log_path: str, env: Dict[str, str],
        hot_spare: bool = False, heal_boost: int = 0,
        zygote: Optional[_Zygote] = None, lift_ok: bool = True,
    ) -> None:
        self.gid = gid
        self.log_path = log_path
        self.env = env
        self.hot_spare = hot_spare
        self.heal_boost = heal_boost
        self.zygote = zygote
        # launcher.py discipline: standbys only warm NICED when the
        # supervisor can lift them back — an unprivileged supervisor
        # warms un-niced (bounded contention) rather than parking spares
        # at a priority nobody can ever restore.
        self.lift_ok = lift_ok
        self.boost_active: Optional[float] = None
        self.proc: Optional[subprocess.Popen] = None
        self.standby: Optional[subprocess.Popen] = None
        self.standby_file: Optional[str] = None
        self.standby_armed_t = 0.0
        self.standby_lifted = False

    def _popen(
        self, extra_env: Dict[str, str], idle: bool = False
    ) -> subprocess.Popen:
        env = {**os.environ, "BENCH_SPAWN_T": str(time.time()), **extra_env,
               **self.env}
        # Import-warm respawn: fork from the phase zygote when the child
        # runs on the CPU (the profile the zygote warmed). The card group
        # takes a REAL interpreter start, so it never shares anything
        # with a process that forked.
        if (
            self.zygote is not None
            and self.zygote.alive()
            and env.get("BENCH_DEVICE") == "cpu"
        ):
            try:
                return self.zygote.spawn(env, nice=19 if idle else 0)
            except Exception:
                pass  # zygote wedged/died: classic spawn still heals
        preexec = None
        if idle:

            def preexec() -> None:
                try:
                    os.nice(19)
                except OSError:
                    pass

        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker"],
            env=env,
            cwd=REPO,
            preexec_fn=preexec,
        )

    def spawn(self) -> None:
        self.proc = self._popen({})
        if self.hot_spare:
            self.arm_standby()

    def arm_standby(self) -> None:
        # Idle priority (launcher.py discipline): standby warm-up
        # (imports + first passes) must not steal cycles from live
        # training. The idle-priority trade is bounded by the warm-deadline
        # lift below: a spare that is STILL warming when the grace expires
        # gets its priority restored so repeat kills find it parked at the
        # gate fully warmed, not mid-import (on a saturated host an idle
        # re-arm never finishes, so every promotion would pay the whole
        # warm-up at heal time).
        self.standby_file = self.log_path + f".standby_{time.time():.3f}"
        self.standby = self._popen(
            {"TORCHFT_STANDBY_FILE": self.standby_file},
            idle=self.lift_ok,
        )
        self.standby_armed_t = time.monotonic()
        self.standby_lifted = False

    def standby_warm(self) -> bool:
        """Whether the parked standby finished warming (standby_gate
        touches ``<standby_file>.warm`` on arrival)."""
        return bool(
            self.standby_file and os.path.exists(self.standby_file + ".warm")
        )

    def lift_slow_warmup(self, deadline_s: float) -> None:
        """Restores a still-warming standby to normal priority once the
        grace window expires (torchft_tpu_torch.launcher applies the same
        policy): bounded contention once per re-arm instead of a cold
        warm-up on every subsequent kill of this group."""
        if (
            not self.lift_ok  # standby was never niced; nothing to lift
            or self.standby is None
            or self.standby.poll() is not None
            or self.standby_lifted
            or self.standby_warm()
            or time.monotonic() - self.standby_armed_t < deadline_s
        ):
            return
        self.standby_lifted = True
        try:
            os.setpriority(os.PRIO_PROCESS, self.standby.pid, 0)
        except (OSError, AttributeError):
            pass

    def restart(self) -> None:
        """Cold respawn, or sub-second promotion of the warm standby
        (the launcher's --hot-spare policy, torchft_tpu_torch.launcher)."""
        if self.standby is not None and self.standby.poll() is None:
            open(self.standby_file, "w").close()
            self.proc = self.standby
            self.standby = None
            try:  # lift the idle priority on promotion (root/CAP_SYS_NICE)
                os.setpriority(os.PRIO_PROCESS, self.proc.pid, 0)
            except (OSError, AttributeError):
                pass
            self.arm_standby()
        else:
            self.proc = self._popen({})
            if self.heal_boost:
                # Heal-priority boost (platform.heal_boost_nice): the
                # cold-restarting member is the cohort's degraded one —
                # lend it survivor CPU while it heals; maybe_deboost
                # returns it to parity at its first committed step.
                try:
                    os.setpriority(
                        os.PRIO_PROCESS, self.proc.pid, -self.heal_boost
                    )
                    self.boost_active = time.time()
                except (OSError, AttributeError):
                    pass
            if self.hot_spare:
                self.arm_standby()

    def maybe_deboost(self) -> None:
        """Ends an active heal boost once the restarted worker committed
        a step (healed — it is a peer again), or after a 60 s hard cap
        (a heal that slow has bigger problems than priority). Reads only
        the log's TAIL, at a 1 s cadence: re-parsing a 1200-record JSONL
        4×/s from the supervisor would load the very CPUs whose
        contention the heal numbers measure."""
        if self.boost_active is None or self.proc is None:
            return
        now = time.time()
        if now < getattr(self, "_deboost_next_check", 0):
            return
        self._deboost_next_check = now + 1.0
        healed = False
        try:
            with open(self.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                start = max(0, f.tell() - 8192)
                f.seek(start)
                tail = f.read().decode(errors="replace").splitlines()
            if start > 0:
                tail = tail[1:]  # first line torn by the mid-file seek
            for line in tail:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("committed") and r.get("t", 0) > self.boost_active:
                    healed = True
                    break
        except OSError:
            pass
        if healed or now - self.boost_active > 60:
            self.boost_active = None
            if self.proc.poll() is None:
                try:
                    os.setpriority(os.PRIO_PROCESS, self.proc.pid, 0)
                except (OSError, AttributeError):
                    pass

    def reap(self) -> None:
        if self.standby is not None and self.standby.poll() is None:
            self.standby.kill()

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


def _read_log(path: str) -> List[dict]:
    records = []
    try:
        with open(path) as f:
            for line in f:
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    pass  # torn write
    except FileNotFoundError:
        pass
    return records


def _committed(records: List[dict]) -> List[dict]:
    return [r for r in records if r.get("committed")]


# Every heal-breakdown phase the artifact can carry, in pipeline order.
# Cold restarts populate all of them; promoted standbys only the ones a
# promotion actually pays (activation / rendezvous / fetch / h2d /
# first_commit) — the absent cold keys are the measurement that the warm
# path skipped that work.
HEAL_PHASES = (
    "activation", "respawn", "import", "setup", "backend_init", "mesh",
    "compile", "join", "rendezvous", "fetch", "h2d", "first_commit",
)


def compute_heal_stats(
    kills: List[dict], logs_by_gid: Dict[int, List[dict]]
) -> tuple:
    """Joins the supervisor's kill timestamps with each victim's log
    records into ``(heal_s, breakdowns)``.

    heal_s: seconds from each SIGKILL to the restarted group's first
    committed step (sorted). breakdowns: one dict of HEAL_PHASES seconds
    per attributable kill — boot-record deltas (respawn / import / setup
    / backend_init / mesh / compile for cold restarts; activation /
    rendezvous for both paths) plus the in-band "heal" record's streamed
    fetch / h2d split. Each kill's window is bounded at the SAME group's
    next kill: if the victim dies again before its restart commits, the
    later kill's commit/boot/heal records must not be attributed to this
    one (that would silently fold an extra kill cycle into the medians).
    Pure function of the logs — unit-testable without running a phase."""
    heal_s = []
    breakdowns = []
    for k in kills:
        next_kill_t = min(
            (
                k2["t"]
                for k2 in kills
                if k2["gid"] == k["gid"] and k2["t"] > k["t"]
            ),
            default=float("inf"),
        )
        log = logs_by_gid.get(k["gid"], [])
        after = [
            r["t"]
            for r in _committed(log)
            if k["t"] < r["t"] < next_kill_t
        ]
        if after:
            heal_s.append(after[0] - k["t"])
        # Match boots by ACTIVATION time: a promoted hot-spare standby was
        # spawned (and imported/warmed) long before the kill, so only its
        # activation falls in this kill's window.
        boots = [
            r["boot"]
            for r in log
            if "boot" in r
            and k["t"] < r["boot"].get("activated_t", r["boot"]["spawn_t"])
            < next_kill_t
        ]
        if boots and after:
            b = boots[0]
            entry = {
                # kill -> warmed process past its gate (cold: respawn +
                # import + setup + backend_init + mesh + compile;
                # promoted standby: just the supervisor poll + gate poll)
                "activation": b["activated_t"] - k["t"],
                # manager/store/quorum-client bring-up ("join" is the
                # same delta, kept for artifact continuity)
                "rendezvous": b["manager_t"] - b["activated_t"],
                "join": b["manager_t"] - b["activated_t"],
                "first_commit": after[0] - b["manager_t"],
            }
            if b["spawn_t"] > k["t"]:
                # Cold restart: the process-boot phases belong to this kill.
                entry.update(
                    {
                        "respawn": b["spawn_t"] - k["t"],
                        "import": b["enter_t"] - b["spawn_t"],
                        "setup": b["setup_t"] - b["enter_t"],
                    }
                )
                if "backend_t" in b and "model_t" in b:
                    entry.update(
                        {
                            "backend_init": b["backend_t"] - b["setup_t"],
                            "mesh": b["model_t"] - b["backend_t"],
                            "compile": b["compiled_t"] - b["model_t"],
                        }
                    )
                else:  # pre-split boot record: one opaque compile bucket
                    entry["compile"] = b["compiled_t"] - b["setup_t"]
            # The streamed-heal transfer split, recorded in-band by the
            # worker when its manager healed from a live peer.
            heals = [
                r["heal"]
                for r in log
                if "heal" in r and k["t"] < r["heal"]["t"] < next_kill_t
            ]
            if heals:
                entry["fetch"] = heals[0].get("fetch_s")
                entry["h2d"] = heals[0].get("h2d_s")
            breakdowns.append(
                {n: v for n, v in entry.items() if v is not None}
            )
    heal_s.sort()
    return heal_s, breakdowns


def _steps_per_sec(records: List[dict], skip: int = 5) -> float:
    """Committed steps/sec, excluding the first ``skip`` commits (first
    passes + ramp)."""
    done = _committed(records)[skip:]
    if len(done) < 2:
        return 0.0
    return (len(done) - 1) / (done[-1]["t"] - done[0]["t"])


def _cpu_threads(groups: int) -> str:
    """A CPU group's torch pool: the host's cores over the groups, or the
    value the caller set."""
    return os.environ.get("OMP_NUM_THREADS") or str(
        max(1, (os.cpu_count() or 1) // max(groups, 1)))


def _run_phase(
    name: str,
    groups: int,
    steps: int,
    kill_every: int,
    out_dir: str,
    lighthouse_addr: str,
    card_group0: bool = False,
    hot_spare: bool = False,
    deadline_s: Optional[float] = None,
) -> dict:
    go_path = os.path.join(out_dir, f"{name}.go")
    from torchft_tpu_torch.launcher import _can_lift_priority
    from torchft_tpu_torch.platform import heal_boost_nice

    # One capability probe gates every priority maneuver this phase: the
    # heal boost (needs a negative nice) and standby IDLE warming (only
    # safe when the lift back to 0 is possible — an unprivileged
    # supervisor warms spares un-niced, the launcher.py discipline, or
    # the warm-deadline fix would silently no-op and every repeat kill
    # would promote a half-warmed spare again).
    lift_ok = _can_lift_priority()
    heal_boost = heal_boost_nice() if lift_ok else 0
    threads = _cpu_threads(groups)
    cpu_env = {"BENCH_DEVICE": "cpu", "CUDA_VISIBLE_DEVICES": "",
               "OMP_NUM_THREADS": threads}
    # One import-warm respawn server per phase (see zygote()): restarts
    # of CPU groups fork from it instead of re-importing torch under
    # survivor contention. Warmed with the CPU-worker profile (no card,
    # the CPU groups' pool size); failure to start is non-fatal (classic
    # spawns still work).
    zyg: Optional[_Zygote] = None
    if os.environ.get("TORCHFT_ZYGOTE", "1") != "0":
        try:
            zyg = _Zygote({**os.environ, **cpu_env})
        except Exception as e:  # noqa: BLE001 - degraded, not broken
            print(f"zygote unavailable ({e!r}); classic spawns only",
                  file=sys.stderr)
            zyg = None
    gs: List[_Group] = []
    for g in range(groups):
        log_path = os.path.join(out_dir, f"{name}_g{g}.jsonl")
        gs.append(
            _Group(
                g,
                log_path,
                {
                    # card_group0: the measurement group runs on the card;
                    # its CPU peers are the churn. Kills only ever hit CPU
                    # groups (victim rotates over 1..N-1), so this shows
                    # the CARD-RESIDENT process's throughput under
                    # cross-group churn. CPU groups never create a CUDA
                    # context on the card they do not use.
                    **(
                        {"BENCH_DEVICE": "cuda"}
                        if (card_group0 and g == 0)
                        else cpu_env
                    ),
                    "TORCHFT_LIGHTHOUSE": lighthouse_addr,
                    "REPLICA_GROUP_ID": str(g),
                    "NUM_REPLICA_GROUPS": str(groups),
                    "NUM_STEPS": str(steps),
                    "BENCH_LOG": log_path,
                    "BENCH_GO": go_path,
                },
                # Standbys only for killable groups: kills rotate over
                # 1..N-1, so a group-0 standby would be pure start-up
                # contention against the measurement group.
                hot_spare=hot_spare and g != 0,
                heal_boost=heal_boost,
                zygote=zyg,
                lift_ok=lift_ok,
            )
        )
    # The card group starts a fresh interpreter whatever the zygote does:
    # it starts first, so its imports overlap the zygote's.
    for g in gs:
        if g.env.get("BENCH_DEVICE") != "cpu":
            g.spawn()
    if zyg is not None:
        try:
            zyg.wait_ready()
        except Exception as e:  # noqa: BLE001 - degraded, not broken
            print(f"zygote unavailable ({e!r}); classic spawns only",
                  file=sys.stderr)
            zyg.shutdown()
            zyg = None
            for g in gs:
                g.zygote = None
    for g in gs:
        if g.proc is None:
            g.spawn()

    # Start line: release every group at once, after all have warmed.
    ready_deadline = time.time() + 300
    while time.time() < ready_deadline:
        if all(os.path.exists(g.log_path + ".ready") for g in gs):
            break
        time.sleep(0.25)
    open(go_path, "w").close()

    kills: List[dict] = []
    next_kill = kill_every if kill_every > 0 else None
    victim = 1  # rotate over groups 1..N-1; group 0 is the measurement group
    # Deadline scales with the step target (the default is 1200 steps for
    # kill-count power; a fixed 1200 s cap would silently truncate slow
    # runs back to an under-powered measurement). Truncation is detected
    # and reported either way.
    deadline = time.time() + (
        deadline_s if deadline_s is not None else max(1200, steps * 4)
    )
    timed_out = False
    from torchft_tpu_torch.platform import standby_warm_deadline_s

    warm_deadline = standby_warm_deadline_s()
    try:
        while any(g.alive() for g in gs):
            if time.time() >= deadline:
                timed_out = True
                break
            time.sleep(0.25)
            # Restart any dead group (supervisor role, launcher semantics;
            # promotes the warm standby under --hot-spare). The warm-
            # deadline lift keeps re-armed standbys from starving at idle
            # priority past the next kill of their group.
            for g in gs:
                g.lift_slow_warmup(warm_deadline)
                g.maybe_deboost()
                if g.proc is not None and g.proc.poll() not in (None, 0):
                    g.restart()
            if next_kill is not None:
                lead = len(_committed(_read_log(gs[0].log_path)))
                if lead >= next_kill and lead < steps - 5:
                    v = gs[victim]
                    if v.alive():
                        v.proc.send_signal(signal.SIGKILL)
                        kills.append(
                            {"t": time.time(), "gid": v.gid, "at_step": lead}
                        )
                        victim = victim % (groups - 1) + 1
                    next_kill += kill_every
    finally:
        for g in gs:
            g.reap()  # parked standbys never exit on their own
            if g.alive():
                g.proc.terminate()
        for g in gs:
            if g.proc is not None:
                try:
                    g.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    g.proc.kill()
        if zyg is not None:
            zyg.shutdown()

    # Heal latency: kill -> first commit recorded by the restarted process,
    # broken into HEAL_PHASES via the worker's boot + heal records (see
    # compute_heal_stats).
    heal_s, breakdowns = compute_heal_stats(
        kills, {g.gid: _read_log(g.log_path) for g in gs}
    )

    def _phase_median(name: str) -> Optional[float]:
        vals = sorted(b[name] for b in breakdowns if name in b)
        return round(vals[len(vals) // 2], 2) if vals else None

    # Throughput spread: group 0's committed-step rate over time quarters —
    # the noise floor a churn ratio must be read against.
    g0 = _committed(_read_log(gs[0].log_path))[5:]
    quarter_sps = []
    for i in range(4):
        seg = g0[i * len(g0) // 4 : (i + 1) * len(g0) // 4]
        if len(seg) >= 2:
            quarter_sps.append(
                round((len(seg) - 1) / (seg[-1]["t"] - seg[0]["t"]), 3)
            )

    committed_g0 = len(_committed(_read_log(gs[0].log_path)))
    return {
        "steps_per_sec": round(_steps_per_sec(_read_log(gs[0].log_path)), 3),
        "steps_per_sec_quarters": quarter_sps,
        # Deadline truncation (the phase was cut off mid-run, so the
        # measurement is under-powered). A near-target committed count
        # without a timeout is normal: the first group to finish exits,
        # which can abort one in-flight step on the others.
        "truncated": bool(timed_out),
        "committed_vs_target": f"{committed_g0}/{steps}",
        "kills": len(kills),
        "heal_s": [round(h, 2) for h in heal_s],
        "heal_p50_s": round(heal_s[len(heal_s) // 2], 2) if heal_s else None,
        "heal_breakdown_median_s": {
            name: _phase_median(name) for name in HEAL_PHASES
        }
        if breakdowns
        else None,
        "committed_steps_g0": len(_committed(_read_log(gs[0].log_path))),
    }


# --------------------------------------------------------------------------
# durable phase: async sharded snapshot stall + no-donor restore
# --------------------------------------------------------------------------


def run_durable_phase(
    n_elems: int = 8_000_000,
    checkpoints: int = 4,
    world_old: int = 3,
    world_new: int = 2,
    device: str = "cuda",
    states: Optional[dict] = None,
) -> dict:
    """Bench the durable tier in-process with a fake-manager fleet (the
    durable pipeline's only inputs are ``(step, quorum_id, rank, world)``
    at the commit boundary; the live-Manager integration is covered by
    the chaos ``fleet_loss`` config and tests/test_torch_durable.py).

    Three measurements on an adam-shaped state (f32 params + 2x f32
    opt-state on ``device``, bf16 wire: K3 narrows the moments on the
    card):

      sync_baseline:  W=1 ``mode="sync"`` — the blocking d2h + serialize
                      + write + fsync pipeline on the trainer thread, per
                      checkpoint.
      async_sharded:  W=world_old ``mode="async"`` + ``zero_copy`` —
                      each member's trainer pays only the device copy of
                      its ~1/W shard; d2h/CRC/write/fsync ride the
                      background writer.
      durable_restore: a COLD fleet of W=world_new (no live donor, no
                      overlap with world_old) reassembles the newest
                      committed set, split into manifest-read /
                      shard-fetch / reshard / h2d / compile buckets.

    ``states``, when given, receives member 0's last captured state
    (``"saved"``, a host copy) and the restored members' states
    (``"restored"``), for a caller that holds them."""
    import hashlib
    import statistics
    import tempfile

    import torch

    from torchft_tpu_torch.durable import DurableCheckpointer

    dev = torch.device(device)

    class _Mgr:
        def __init__(self, rank: int, world: int) -> None:
            self._rank, self._world = rank, world
            self._step, self._bc = 0, 0

        def current_step(self) -> int:
            return self._step

        def quorum_id(self) -> int:
            return 1

        def participating_rank(self) -> int:
            return self._rank

        def num_participants(self) -> int:
            return self._world

        def replica_id(self) -> str:
            return f"durable_bench_{self._rank}"

        def state_dict(self) -> dict:
            return {"step": self._step, "batches_committed": self._bc}

        def load_state_dict(self, sd: dict) -> None:
            self._step = sd["step"]
            self._bc = sd["batches_committed"]

        def add_commit_hook(self, fn) -> None:
            pass

    class _St:
        def __init__(self) -> None:
            z = torch.zeros((n_elems,), dtype=torch.float32, device=dev)
            self.params = {"w": z + 0.5}
            self.opt_state = {"m": z, "v": z.clone()}

        def state_dict(self) -> dict:
            return {"params": self.params, "opt_state": self.opt_state}

        def load_state_dict(self, sd) -> None:
            self.params = sd["params"]
            self.opt_state = sd["opt_state"]

    # functional (non-updating-in-place) update — the regime the durable
    # zero-copy capture is benched in
    def update(w, m, v, g):
        return (
            w - 0.1 * (0.9 * m + 0.1 * g),
            0.9 * m + 0.1 * g,
            0.99 * v + 0.01 * g * g,
        )

    def train_step(st: "_St", step: int) -> None:
        g = torch.full((n_elems,), 0.001 * step, dtype=torch.float32,
                       device=dev)
        w, m, v = update(
            st.params["w"], st.opt_state["m"], st.opt_state["v"], g
        )
        st.params = {"w": w}
        st.opt_state = {"m": m, "v": v}
        _drain(dev)

    record: Dict[str, object] = {
        "phase": "durable",
        "config": {
            "n_elems": n_elems,
            "checkpoints": checkpoints,
            "world_old": world_old,
            "world_new": world_new,
            "wire": "bf16",
            "host_cpus": os.cpu_count(),
        },
    }

    with tempfile.TemporaryDirectory(prefix="durable_bench_") as tmp:
        # -- sync baseline (blocking writer, full state) --
        sync_dir = os.path.join(tmp, "sync")
        mgr = _Mgr(0, 1)
        st = _St()
        train_step(st, 0)  # materialize state
        cp = DurableCheckpointer(
            sync_dir, mgr, st, every=1, keep=2, mode="sync",
            commit_timeout_s=60.0, device=dev,
        )
        for step in range(1, checkpoints + 1):
            train_step(st, step)
            mgr._step, mgr._bc = step, step
            cp.maybe_save()
        cp.flush(120.0)
        cp.close()
        sync_stalls = [r["stall_s"] for r in cp.snapshots]
        total_bytes = int(cp.snapshots[0]["total_bytes"])
        record["config"]["total_bytes"] = total_bytes  # type: ignore[index]
        record["sync_baseline"] = {
            "mode": "sync",
            "world": 1,
            "stall_s": [round(s, 6) for s in sync_stalls],
            "stall_p50_s": round(statistics.median(sync_stalls), 6),
            "durable_bytes_per_member": total_bytes,
        }

        # -- async sharded zero-copy snapshots at W=world_old --
        async_dir = os.path.join(tmp, "async")
        mgrs = [_Mgr(r, world_old) for r in range(world_old)]
        sts = [_St() for _ in range(world_old)]
        for s in sts:
            train_step(s, 0)
        cps = [
            DurableCheckpointer(
                async_dir, m, s, every=1, keep=2, mode="async",
                zero_copy=True, commit_timeout_s=60.0, device=dev,
            )
            for m, s in zip(mgrs, sts)
        ]
        for step in range(1, checkpoints + 1):
            for s in sts:  # deterministic: members stay replicated
                train_step(s, step)
            for m in mgrs:
                m._step, m._bc = step, step * world_old
            for c in cps:
                c.maybe_save()
        flushed = all(c.flush(120.0) for c in cps)
        for c in cps:
            c.close()
        committed_steps = cps[0].committed_steps()
        rows = [r for c in cps for r in c.snapshots]
        async_stalls = [r["stall_s"] for r in rows]
        shard_bytes = sorted({int(r["shard_bytes"]) for r in rows})
        record["async_sharded"] = {
            "mode": "async",
            "world": world_old,
            "zero_copy": True,
            "rows": [
                {
                    k: (round(v, 6) if k == "stall_s" else v)
                    for k, v in r.items()
                }
                for r in rows
            ],
            "stall_p50_s": round(statistics.median(async_stalls), 6),
            "stall_mean_s": round(
                sum(async_stalls) / len(async_stalls), 6
            ),
            "shard_bytes": shard_bytes,
            "committed_steps": committed_steps,
            "flushed": flushed,
        }
        sync_mean = sum(sync_stalls) / len(sync_stalls)
        async_mean = sum(async_stalls) / len(async_stalls)
        record["stall_ratio_vs_sync"] = round(
            async_mean / sync_mean, 4
        ) if sync_mean else None
        # per-member durable bytes ~ total/W (floor split slack < W)
        record["shard_scaling_ok"] = bool(
            max(int(r["shard_bytes"]) for r in rows)
            <= total_bytes // world_old + world_old
        )
        if states is not None:
            states["saved"] = {
                k: {n: t.detach().cpu() for n, t in tree.items()}
                for k, tree in sts[0].state_dict().items()
            }

        # -- no-donor cold restore at a DIFFERENT W --
        new_mgrs = [_Mgr(r, world_new) for r in range(world_new)]
        new_sts = [_St() for _ in range(world_new)]
        restores = []
        t_all = time.perf_counter()
        for m, s in zip(new_mgrs, new_sts):
            rcp = DurableCheckpointer(async_dir, m, s, every=1, device=dev)
            t0 = time.perf_counter()
            step = rcp.restore_latest()
            wall = time.perf_counter() - t0
            stats = dict(rcp.last_restore_stats or {})
            stats["restored_step"] = step
            stats["wall_s"] = wall
            restores.append(stats)
            rcp.close()
        # compile bucket: the first update on the restored state, through
        # a fresh function object
        def restep(w, g):
            return w - 0.1 * g

        t0 = time.perf_counter()
        restep(
            new_sts[0].params["w"],
            torch.full((n_elems,), 0.001, dtype=torch.float32, device=dev),
        )
        _drain(dev)
        compile_s = time.perf_counter() - t0
        digests = {
            hashlib.sha256(
                s.params["w"].detach().cpu().numpy().tobytes()).hexdigest()
            for s in new_sts
        }
        if states is not None:
            states["restored"] = [s.state_dict() for s in new_sts]
        r0 = restores[0]
        record["durable_restore"] = {
            "kind": "no_donor_cold_restore",
            "world_old": world_old,
            "world_new": world_new,
            "restored_step": r0.get("restored_step"),
            "bytes": r0.get("bytes"),
            "manifest_read_s": round(r0.get("manifest_read_s", 0.0), 6),
            "shard_fetch_s": round(r0.get("shard_fetch_s", 0.0), 6),
            "reshard_s": round(r0.get("reshard_s", 0.0), 6),
            "h2d_s": round(r0.get("h2d_s", 0.0), 6),
            "compile_s": round(compile_s, 6),
            "wall_s": round(r0.get("wall_s", 0.0), 6),
            "fleet_wall_s": round(time.perf_counter() - t_all, 6),
            "members_bit_identical": len(digests) == 1,
            "per_member": [
                {
                    k: (round(v, 6) if isinstance(v, float) else v)
                    for k, v in r.items()
                }
                for r in restores
            ],
        }
    return record


def run_durable_main(dryrun: bool, out: Optional[str],
                     device: str = "cuda") -> int:
    record = run_durable_phase(
        n_elems=1_000_000 if dryrun else 8_000_000,
        checkpoints=2 if dryrun else 4,
        device=device,
    )
    snaps = record["async_sharded"]
    restore = record["durable_restore"]
    ratio = record["stall_ratio_vs_sync"]
    # one committed async-snapshot record + one no-donor-restore record
    # with every bucket present: the dryrun contract, asserted on full
    # runs too (a bench that can't produce its own headline rows should
    # fail, not publish an empty artifact)
    ok = (
        bool(snaps["committed_steps"])
        and bool(snaps["flushed"])
        and any(r["committed"] for r in snaps["rows"])
        and restore["restored_step"] == max(snaps["committed_steps"])
        and restore["members_bit_identical"]
        and all(
            restore[k] is not None
            for k in (
                "manifest_read_s", "shard_fetch_s", "reshard_s",
                "h2d_s", "compile_s",
            )
        )
        and record["shard_scaling_ok"]
    )
    record["measurement_ok"] = ok and ratio is not None and ratio <= 0.05
    print(
        json.dumps(
            {
                "metric": (
                    "durable_dryrun_ok" if dryrun else "durable_stall_ratio"
                ),
                "value": (1 if ok else 0) if dryrun else ratio,
                "unit": "bool" if dryrun else "ratio",
                "stall_ratio_vs_sync": ratio,
                "restored_step": restore["restored_step"],
                "restore_wall_s": restore["wall_s"],
            }
        ),
        flush=True,
    )
    if dryrun:
        return 0 if ok else 1  # smoke only, NO artifact
    if out:
        with open(out, "w") as f:
            json.dump(record, f, indent=2)
    return 0 if ok else 1


def _build(on_card: bool) -> None:
    """Builds the native library and, for a run on the card, the kernels
    (one nvcc per source), before any worker or the zygote starts: they
    load the built files, they never build them."""
    from torchft_tpu_torch import _build

    errors: List[str] = []

    def run(fn) -> None:
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - reported below, then fatal
            errors.append(f"{fn.__name__}: {e}")

    threads = [threading.Thread(target=run, args=(fn,)) for fn in
               ([_build.build_native]
                + ([_build.build_kernels] if on_card else []))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("build failed: " + "; ".join(errors))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--worker", action="store_true")
    parser.add_argument("--zygote", action="store_true")
    parser.add_argument("--groups", type=int, default=4)
    # >= 10 kills over >= 1000 steps: 2 kills over 300 steps left the
    # effect smaller than the noise (ratio measured > 1).
    parser.add_argument("--steps", type=int, default=1200)
    parser.add_argument("--kill-every", type=int, default=100)
    parser.add_argument(
        "--device",
        default=None,
        help="cpu: run group 0 (and the durable state) on the host CPU, "
        "the CPU rehearsal; default the card (exits 2 without one). Kills "
        "only ever hit the CPU peer groups",
    )
    parser.add_argument(
        "--hot-spare",
        action="store_true",
        help="also run a churn phase where restarts promote a pre-warmed "
        "standby (the launcher's --hot-spare policy) instead of cold-"
        "restarting",
    )
    parser.add_argument(
        "--durable",
        action="store_true",
        help="bench the durable checkpoint tier instead of churn: async "
        "sharded snapshot stall vs the synchronous writer, 1/W shard "
        "bytes, and the cold no-donor restore breakdown (with --dryrun: "
        "the smoke, no artifact)",
    )
    parser.add_argument(
        "--dryrun",
        action="store_true",
        help="seconds-scale smoke: 2 groups, a few dozen steps, kills in "
        "each churn phase (cold + hot-spare), tight deadlines, NO "
        "artifact written — exercises the whole kill/heal/promotion "
        "path so it can't silently rot between perf rounds",
    )
    parser.add_argument("--out", default=None,
                        help="write the result JSON here (default: none)")
    args = parser.parse_args()
    if args.worker:
        worker()
        return
    if args.zygote:
        zygote()
        return

    import torch

    on_card = args.device is None or torch.device(args.device).type != "cpu"
    if on_card and not torch.cuda.is_available():
        print("bench_churn_torch: no CUDA device: this tool runs group 0 "
              "and the durable state on the card; pass --device cpu for a "
              "CPU rehearsal", file=sys.stderr, flush=True)
        sys.exit(EXIT_NO_CARD)
    device = "cuda" if on_card else "cpu"
    _build(on_card)
    if args.durable:
        sys.exit(run_durable_main(dryrun=args.dryrun, out=args.out,
                                  device=device))
    if args.dryrun:
        # Kill early in a window long enough that the donor is still
        # alive and committing when the victim's restart comes up — a
        # kill near the end lets survivors finish and exit first, and
        # the restart then rejoins solo without a checkpoint heal.
        args.groups = 2
        args.steps = 48
        args.kill_every = 10
        args.hot_spare = True

    from torchft_tpu_torch import Lighthouse

    out_dir = os.path.join(REPO, ".bench_churn_torch_logs")
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(out_dir):
        path = os.path.join(out_dir, f)
        if not os.path.isdir(path):
            os.unlink(path)

    # Failure detection speed comes from heartbeat_timeout (a dead member
    # leaves the healthy set after 500 ms and the join gate does not apply
    # to it). join_timeout must exceed a STEP TIME: the gate holds quorum
    # formation for healthy-but-not-yet-requesting members, and members
    # re-request once per step — a 200 ms gate under >200 ms steps lets
    # sub-quorums form between paced requests, flapping membership and
    # starving a joiner.
    lighthouse = Lighthouse(
        bind="[::]:0",
        min_replicas=1,
        join_timeout_ms=2000,
        quorum_tick_ms=50,
        heartbeat_timeout_ms=500,
    )

    phase_deadline = 300.0 if args.dryrun else None
    healthy = _run_phase(
        "healthy", args.groups, args.steps, 0, out_dir, lighthouse.address(),
        card_group0=on_card, deadline_s=phase_deadline,
    )
    churn = _run_phase(
        "churn", args.groups, args.steps, args.kill_every, out_dir,
        lighthouse.address(), card_group0=on_card,
        deadline_s=phase_deadline,
    )
    churn_hot = None
    if args.hot_spare:
        # Third phase: same kill schedule, restarts by standby PROMOTION
        # (launcher --hot-spare). The cold phase above stays in the
        # artifact so both restart policies' heal latencies are on record.
        churn_hot = _run_phase(
            "churn_hot", args.groups, args.steps, args.kill_every, out_dir,
            lighthouse.address(), card_group0=on_card, hot_spare=True,
            deadline_s=phase_deadline,
        )
    lighthouse.shutdown()

    ratio = (
        round(churn["steps_per_sec"] / healthy["steps_per_sec"], 3)
        if healthy["steps_per_sec"]
        else 0.0
    )
    # Noise gate: churn measuring FASTER than healthy by > 5% means the
    # run-to-run noise exceeds the effect under measurement — record the
    # run as too noisy instead of claiming an absurd ratio (a fault-
    # tolerance layer cannot beat the fault-free loop).
    quarters = healthy.get("steps_per_sec_quarters") or []
    spread = (
        round((max(quarters) - min(quarters)) / max(quarters), 3)
        if quarters
        else None
    )
    from torchft_tpu_torch.chaos import bench_fault_stamp

    result = {
        "config": {
            "groups": args.groups,
            "steps": args.steps,
            "kill_every": args.kill_every,
            "host_cpus": os.cpu_count(),
            "card_group0": on_card,
        },
        # The seeded schedule (env TORCHFT_CHAOS_SEED/_PLAN) plus this
        # bench's own fault knobs: any anomaly in this artifact replays
        # via scripts/chaos_run_torch.py --seed.
        "fault_plan": bench_fault_stamp(
            bench="bench_churn_torch", kill_every=args.kill_every,
            kill_kind="sigkill",
        ),
        "healthy": healthy,
        "churn": churn,
        "churn_hot_spare": churn_hot,
        "ratio": ratio,
        "ratio_hot_spare": (
            round(churn_hot["steps_per_sec"] / healthy["steps_per_sec"], 3)
            if churn_hot and healthy["steps_per_sec"]
            else None
        ),
        "healthy_quarter_spread": spread,
        "measurement_ok": bool(
            ratio <= 1.05
            and not healthy.get("truncated")
            and not churn.get("truncated")
        ),
        "target": 0.90,
        "note": "all host groups share this machine's CPUs, so heal "
        "numbers carry contention the target deployment (one host per "
        "group) does not have. Hot-spare policy: standbys re-arm at IDLE "
        "priority so warm-up never steals training cycles, with a "
        "bounded warm-deadline lift (TORCHFT_STANDBY_WARM_DEADLINE_S) "
        "restoring a still-warming spare to normal priority so repeat "
        "kills find it fully warmed. Promotion = quorum join + streamed "
        "weight fetch only: the spare parks with its device up, its "
        "first forward/backward, optimizer update and ring pack done, "
        "and collectives pre-created. Heal transfer rides the streamed "
        "checkpoint pipeline (fetch/h2d keys in heal_breakdown_median_s; "
        "TORCHFT_HEAL_WIRE/TORCHFT_HEAL_STREAMS tune it).",
    }
    if args.dryrun:
        # Smoke only: assert the paths ran (kills happened, heals
        # completed, breakdown keys exist, AND at least one heal rode
        # the stream transport — a regression that silently falls back
        # to the pickled fetch must fail, not stay green because heals
        # still limp through), write NO artifact.
        stream_heals = 0
        for fname in os.listdir(out_dir):
            if fname.endswith(".jsonl") and "churn" in fname:
                stream_heals += sum(
                    1
                    for r in _read_log(os.path.join(out_dir, fname))
                    if r.get("heal", {}).get("path") == "stream"
                )
        ok = (
            churn["kills"] >= 1
            and churn["heal_p50_s"] is not None
            and churn_hot is not None
            and churn_hot["kills"] >= 1
            and churn_hot["heal_p50_s"] is not None
            and stream_heals >= 1
            # at least one KILL-window heal carried the streamed
            # fetch/h2d split into the artifact keys
            and any(
                (p.get("heal_breakdown_median_s") or {}).get("fetch")
                is not None
                for p in (churn, churn_hot)
            )
        )
        print(
            json.dumps(
                {
                    "metric": "churn_dryrun_ok",
                    "value": 1 if ok else 0,
                    "unit": "bool",
                    "heal_p50_s": churn["heal_p50_s"],
                    "heal_p50_hot_s": (
                        churn_hot["heal_p50_s"] if churn_hot else None
                    ),
                    "stream_heals": stream_heals,
                }
            ),
            flush=True,
        )
        sys.exit(0 if ok else 1)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    print(
        json.dumps(
            {
                "metric": "steps_per_sec_churn_ratio",
                "value": ratio,
                "unit": "ratio",
                "vs_baseline": round(ratio / 0.90, 3),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()

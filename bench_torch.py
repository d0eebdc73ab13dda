"""Benchmark on the port: fault-tolerant training throughput on the card.

The counterpart of ``bench.py`` for ``torchft_tpu_torch`` on an NVIDIA GPU,
function by function under the same names. It measures the whole
fault-tolerance path against a raw train loop of the same model on the
same card, over a real cross-replica-group data plane: a second replica
group (a peer process on the host CPU, contributing zeros) joins the
quorum and the host TCP ring, so every cross-group byte is packed,
shipped and unpacked, while the measured process has the card alone.

Every measurement window is wall-clock boxed (run for T seconds, count
the steps that completed, check the clock at drain boundaries); window
lengths derive from this run's measured warm sync; every later phase
checks the remaining budget first (a skipped phase is recorded); the
supervisor runs one attempt that fits ``BENCH_ATTEMPT_TIMEOUT_S``.

Phases (recorded in the ``--out`` JSON):

  raw           the fused train step (``make_train_step``), no FT machinery.
  transfer      d2h / h2d MB/s of a 16 MB tensor through pageable memory.
  ft_diloco     AsyncDiLoCo on the dense model: inner steps stay on the
                card, the compressed pseudogradient sync runs once per
                window. Two time-boxed windows, best of; the provisional
                headline lands after the first.
  ft_ddp_small  (card) per-step DDP at a link-sized scale: a ~0.72M-param
                S-2048 flash LM on the int8 wire (K1a/K1b, K2, K4/K5),
                batch sized from a live probe of the per-step overhead,
                with the per-phase breakdown.
  ft_ddp        per-step gradient allreduce at the dense model (blocking
                and pipelined) against a raw loop at the same batch; on
                the CPU both a 4x-token batch and the small batch.
  big           (card) the 111M-param flash LM: raw (flash and dense
                measured) against AsyncDiLoCo windows, best-of-2 on both
                sides; its FT/raw ratio is the last headline.
  big2          (card) one raw MFU point at d_model 2048, head_dim 128.

Where it departs from ``bench.py``: there is no CPU fallback (without a
card and without ``--device cpu`` it exits 2 naming the missing card); a
phase error is recorded, what was measured is printed, and the process
then exits 1; results go to ``--out`` only; MFU is against the card's
datasheet bf16 rate and its measured 8192^3 bf16 matmul, not a TPU's.

The north star is >= 90% of healthy-state throughput, so the printed line
reports ``vs_baseline = (ft_steps_per_sec / raw_steps_per_sec) / 0.90``:
{"metric": "steps_per_sec_ft", "value": 42.1, "unit": "steps/s",
 "vs_baseline": 1.01, "platform": "cuda"}

Usage:
    python bench_torch.py --out result.json             # on the card
    python bench_torch.py --device cpu --out result.json  # CPU rehearsal
Environment: BENCH_ATTEMPT_TIMEOUT_S (the attempt's budget, default
1000: phases that would not fit are skipped; on the CPU a smaller one
also shrinks every wall-clock window in proportion),
BENCH_MODEL, BENCH_WIRE, BENCH_FORCE_DDP, BENCH_SKIP_BIG, BENCH_SKIP_BIG2,
BENCH_SKIP_DENSE, BENCH_BACKEND_PROBE_S, BENCH_INIT_WATCHDOG_S, as in
bench.py.
"""

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from contextlib import ExitStack, contextmanager
from datetime import timedelta

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from torchft_tpu_torch._tree import flatten  # noqa: E402

_T0 = time.monotonic()  # process start, for supervisor-budget guards
# The child process plans its phases to FINISH inside the supervisor's
# deadline; _remaining() is the planning primitive (the margin covers the
# final writes and teardown).
_BUDGET_S = float(os.environ.get("BENCH_ATTEMPT_TIMEOUT_S", 1000))
# The windows are bench.py's. A CPU rehearsal (``run`` on the CPU) with a
# budget under 1000 s shrinks them in proportion, so a short attempt still
# measures every phase; on the card the budget only skips phases, as in
# bench.py.
_window_scale = 1.0
# exit code of a run refused for want of a card (the supervisor does not
# retry it)
EXIT_NO_CARD = 2


def _remaining(margin: float = 30.0) -> float:
    return _BUDGET_S - margin - (time.monotonic() - _T0)


def _win(seconds: float) -> float:
    return seconds * _window_scale


# The link-sized per-step DDP model (bench.py's DDP_SMALL_CONFIG): ~0.72M
# params, lots of compute per param.
DDP_SMALL_CONFIG = dict(
    vocab_size=512,
    d_model=128,
    n_heads=2,
    n_layers=2,
    d_ff=512,
    max_seq_len=2048,
)

# The dense bf16 tensor-core rate of the card (NVIDIA H100 Tensor Core GPU
# datasheet, SXM5 part: 1,979 TFLOP/s with sparsity, 989 without). The
# SXM5 part names itself "NVIDIA H100 80GB HBM3"; the PCIe and NVL parts
# have other rates and names, and get none here. The experiments take it
# (and ``card``) from here.
DATASHEET_BF16 = {"NVIDIA H100 80GB HBM3": 989e12}


def _env_wire():
    """BENCH_WIRE as a compress dtype; the special value "ddp" is a
    force-DDP trigger, not a wire dtype."""
    w = os.environ.get("BENCH_WIRE")
    return None if w == "ddp" else w


def _model_config(size: str, on_card: bool) -> tuple:
    """``(cfg, batch_size, seq_len)`` of a size: the card gets bench.py's
    TPU branch (the full widths), the CPU its small branch."""
    from torchft_tpu_torch.models.transformer import TransformerConfig

    # The ring peer must build the same param tree as the main process
    # although it runs on the CPU: main exports its layer count.
    forced_layers = os.environ.get("BENCH_FORCE_LAYERS")
    if size == "ddp_small":
        # ~0.72M params -> 0.73 MB on the int8 wire, S 2048 attention
        # through the flash kernels (head_dim 64) on the card; the batch
        # is chosen per link in _bench_ddp_small from a measured probe.
        cfg = TransformerConfig(**DDP_SMALL_CONFIG, use_flash=on_card)
        return cfg, int(os.environ.get("BENCH_DDP_SMALL_BATCH", 64)), 2048
    if size == "big":
        # the flash cell's LM: 111,166,464 params, d_model 1024, seq 2048
        cfg = TransformerConfig(vocab_size=8192, d_model=1024, n_heads=16,
                                n_layers=8, d_ff=4096, max_seq_len=2048)
        return cfg, 16, 2048
    if size == "big2":
        # d_model 2048, head_dim 128: higher arithmetic intensity per byte
        cfg = TransformerConfig(vocab_size=8192, d_model=2048, n_heads=16,
                                n_layers=6, d_ff=8192, max_seq_len=2048,
                                use_flash=True)
        return cfg, 8, 2048
    cfg = TransformerConfig(
        vocab_size=8192, d_model=512, n_heads=8,
        n_layers=int(forced_layers) if forced_layers else (6 if on_card else 2),
        d_ff=2048, max_seq_len=512)
    return cfg, (16 if on_card else 4), (512 if on_card else 128)


def _model_setup(size: str = None, device="cpu") -> tuple:
    """``(cfg, batch, on_card)``: the size's config (``BENCH_MODEL`` when
    ``size`` is None) and bench.py's batch, drawn from numpy's seed 0 as
    it draws it, as int64 tokens on ``device``."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    size = size or os.environ.get("BENCH_MODEL", "small")
    cfg, batch_size, seq_len = _model_config(size, on_card)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(batch_size, seq_len),
                          dtype=np.int32)
    return cfg, torch.from_numpy(tokens.astype(np.int64)).to(device), on_card


def _n_params(cfg) -> int:
    """The LM's parameter count from its config (no allocation)."""
    d, f = cfg.d_model, cfg.d_ff
    block = 2 * d + 3 * d * d + d * d + 2 * d * f
    return cfg.vocab_size * d + cfg.max_seq_len * d + d + cfg.n_layers * block


def _grad_params(cfg, device, params=None):
    """``params`` (default: seed 0's) as leaves that take gradients: the
    per-step paths differentiate the state's own tensors
    (``make_grad_fn``), where the fused step makes working copies."""
    from torchft_tpu_torch._tree import tree_map
    from torchft_tpu_torch.models.transformer import init_params

    if params is None:
        params = init_params(cfg, 0, device)
    return tree_map(lambda l: l.requires_grad_(True), params)


def _mark(msg: str) -> None:
    """Timestamped phase marker on stderr."""
    print(f"[bench_torch {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


# Set by _acquire_backend ("cuda" or "cpu"); stamped into every metric line.
_METRIC_PLATFORM: str = ""


def _metric_platform_fields() -> dict:
    return {"platform": _METRIC_PLATFORM} if _METRIC_PLATFORM else {}


_PROBE = ("import torch\n"
          "ok = torch.cuda.is_available()\n"
          "if ok:\n"
          "    torch.ones(1, device='cuda').sum().item()\n"
          "print('cuda' if ok else 'cpu')\n")


def _probe_backend_child(deadline_s: float = None, tries: int = 2,
                         _cmd=None) -> "str | None":
    """Probes the card (``torch.cuda.is_available()`` and one tiny launch)
    in a short-deadline child process, ``tries`` times: a child can be
    killed outright on a hang, and this process's CUDA state stays
    untouched until the probe says the card works. Returns "cuda", "cpu"
    (no card), or None when every try timed out or failed."""
    if deadline_s is None:
        deadline_s = float(os.environ.get("BENCH_BACKEND_PROBE_S", "90"))
    cmd = _cmd or [sys.executable, "-c", _PROBE]
    for attempt in range(tries):
        t0 = time.monotonic()
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=deadline_s)
        except subprocess.TimeoutExpired:
            _mark(f"backend probe {attempt + 1}/{tries} hung past "
                  f"{deadline_s:.0f}s")
            continue
        lines = out.stdout.strip().splitlines()
        if out.returncode == 0 and lines:
            plat = lines[-1].strip()
            _mark(f"backend probe: {plat} in {time.monotonic() - t0:.1f}s")
            return plat
        _mark(f"backend probe {attempt + 1}/{tries} failed rc="
              f"{out.returncode}: {out.stderr.strip()[-300:]}")
    return None


class NoCard(RuntimeError):
    """The run needs a card and there is none (no CPU fallback)."""


def _acquire_backend(device_arg: "str | None" = None) -> torch.device:
    """The device of this run. ``--device cpu`` is taken as asked;
    otherwise the card, probed first in a child: a failed probe raises
    :class:`NoCard` (bench.py fell back to a full CPU run here; the port
    never does)."""
    global _METRIC_PLATFORM
    if device_arg is not None and torch.device(device_arg).type == "cpu":
        _METRIC_PLATFORM = "cpu"
        return torch.device("cpu")
    plat = _probe_backend_child()
    if plat != "cuda":
        raise NoCard(
            f"no CUDA device (probe: {plat}): bench_torch.py runs on the "
            "card; pass --device cpu for a CPU rehearsal")
    _METRIC_PLATFORM = "cuda"
    from torchft_tpu_torch._device import resolve_device

    return resolve_device(device_arg)


def _barrier(tree) -> None:
    """Readback barrier: drains the card, then reads one element."""
    leaf = flatten(tree)[0][0]
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    leaf.detach().reshape(-1)[0:1].cpu()


def _timed_window(run_step, drain, budget_s, max_steps=1 << 30,
                  rate_hint=None) -> tuple:
    """The one wall-clock-boxed stepping discipline every phase shares
    (bench.py's): runs ``run_step()`` until ``budget_s`` seconds elapse or
    ``max_steps`` complete, checking the clock at drain boundaries (about
    6 s of work at the observed rate, or the whole budget when it is
    shorter, bounded [1, 512]; one step when fewer than 2 fit). Returns
    ``(steps, elapsed_s)``, the final drain inside the clock."""
    work_s = min(6.0, budget_s)  # bench.py's windows are all >= 6 s

    def clamp_interval(rate: float) -> int:
        if rate * work_s < 2.0:
            return 1
        return max(1, min(512, int(rate * work_s)))

    interval = clamp_interval(rate_hint or 40.0)
    t0 = time.perf_counter()
    n = 0
    while n < max_steps:
        burst = min(interval, max_steps - n)
        for _ in range(burst):
            run_step()
        n += burst
        drain()
        el = time.perf_counter() - t0
        if el >= budget_s:
            break
        interval = clamp_interval(n / el)
    return n, time.perf_counter() - t0


def _time_raw_loop(step_fn, init_fn, tx, batch, warm: int, budget_s: float,
                   rate_hint=None, max_steps=1 << 30) -> float:
    """Warm + time-boxed raw loop (fresh state per call; the barrier
    drains before the clock starts; ``step_fn`` is the fused train step,
    ``make_train_step``). Returns steps/s."""
    box = {"p": init_fn(), "o": None, "l": None}
    box["o"] = tx.init(box["p"])

    def run_step():
        box["p"], box["o"], box["l"] = step_fn(box["p"], box["o"], batch)

    t_warm = time.perf_counter()
    for _ in range(warm):
        run_step()
    _barrier(box["p"])
    if rate_hint is None and warm:
        # derived from the warm loop (which first-call costs slow down):
        # an underestimate only means an extra early drain
        rate_hint = warm / max(time.perf_counter() - t_warm, 1e-6)
    n, el = _timed_window(run_step, lambda: float(box["l"]), budget_s,
                          max_steps=max_steps, rate_hint=rate_hint)
    return n / el


def _peer_zeros(params, peer_dtype: "str | None"):
    """The peer's zero contribution per ``BENCH_PEER_DTYPE``: ``int8``, the
    ``{q, scale}`` allgather payload (int8 leaves, 0-d f32 scales);
    ``q8``, an f32 tree (the ring quantizes per chunk); ``bf16``, a bf16
    tree; else the params' own dtypes."""
    from torchft_tpu_torch._tree import tree_map

    if peer_dtype == "int8":
        return {
            "q": tree_map(lambda l: torch.zeros(l.shape, dtype=torch.int8),
                          params),
            "scale": tree_map(lambda l: torch.zeros((), dtype=torch.float32),
                              params),
        }
    if peer_dtype == "q8":
        return tree_map(lambda l: torch.zeros(l.shape, dtype=torch.float32),
                        params)
    wire = torch.bfloat16 if peer_dtype == "bf16" else None
    return tree_map(lambda l: torch.zeros(l.shape, dtype=wire or l.dtype),
                    params)


def peer() -> None:
    """CPU ring peer: a second replica group that paces the quorum and the
    ring (contributing zeros) so the main process's data plane is real.
    It runs on the host CPU by design: it measures nothing."""
    from torchft_tpu_torch import HostCollectives, Manager
    from torchft_tpu_torch.models.transformer import init_params

    cfg, _, _ = _model_setup(device="cpu")
    params = init_params(cfg, 0, "cpu")
    peer_dtype = os.environ.get("BENCH_PEER_DTYPE")
    zeros = _peer_zeros(params, peer_dtype)
    state = {"params": params}
    collectives = HostCollectives(timeout=timedelta(seconds=1800))
    manager = Manager(
        collectives=collectives,
        load_state_dict=state.update,
        state_dict=lambda: dict(state),
        min_replica_size=1,
        timeout=timedelta(seconds=1800),
        quorum_timeout=timedelta(seconds=1800),
        rank=0,
        world_size=1,
        lighthouse_addr=os.environ["TORCHFT_LIGHTHOUSE"],
        replica_id="bench_peer",
        device="cpu",
    )
    # Ready: heartbeats flow, so the main side's quorum holds the door
    # until our first quorum request lands.
    open(os.environ["BENCH_PEER_READY"], "w").close()
    # Hold until the main side joins (bench.py's peer says why); the
    # barrier's final quorum IS the main side's round-0 quorum.
    # allow_heal=False throughout: the synthetic peer never heals.
    manager.start_quorum(allow_heal=False)
    manager.wait_quorum()
    while manager.num_participants() < 2:
        time.sleep(0.1)
        manager.start_quorum(allow_heal=False)
        manager.wait_quorum()
    print(f"peer: joined ring, participants={manager.num_participants()}",
          flush=True)
    # The peer never votes or commits: its step stays 0, so it is never a
    # recovery source and leaves the max-step cohort after round 0.
    # rounds == 0: paced by the main side until killed.
    rounds = int(os.environ["BENCH_PEER_ROUNDS"])
    i = 0
    while rounds == 0 or i < rounds:
        if i > 0:
            manager.start_quorum(allow_heal=False)
        if peer_dtype == "int8":
            manager.allgather(zeros).wait()
        elif peer_dtype == "q8":
            manager.allreduce(zeros, wire="q8").wait()
        else:
            manager.allreduce(zeros).wait()
        print(f"peer: round {i} done participants="
              f"{manager.num_participants()}", flush=True)
        i += 1
    manager.shutdown()
    collectives.shutdown()


def _peer_env(lighthouse_addr: str, rounds: int, dtype: str,
              ready: str) -> dict:
    """What a peer's environment adds: the knobs that shape its tree and
    its ring (``BENCH_*``, ``TORCHFT_*``), where to find the lighthouse,
    its rounds and wire, its ready file, and no card."""
    env = {k: v for k, v in os.environ.items()
           if k.startswith(("BENCH_", "TORCHFT_"))}
    env.update({
        "TORCHFT_LIGHTHOUSE": lighthouse_addr,
        "BENCH_PEER_ROUNDS": str(rounds),
        "BENCH_PEER_DTYPE": dtype,
        "BENCH_PEER_READY": ready,
        "TORCHFT_TPU_LOG": "info",
        "CUDA_VISIBLE_DEVICES": "",
    })
    env.pop("BENCH_INNER", None)
    return env


def _spawn_peer(lighthouse_addr: str, rounds: int, dtype: str,
                popen=None) -> subprocess.Popen:
    """Starts ``bench_torch.py --peer`` and waits for its ready file. Its
    ready file and log live in a temporary directory (``proc.peer_dir``,
    removed by the session). ``popen(argv, log_path, env)`` starts the
    process another way (a pool of warm interpreters); default, a fresh
    one."""
    tmp = tempfile.mkdtemp(prefix="bench_torch_peer_")
    ready = os.path.join(tmp, "ready")
    log_path = os.path.join(tmp, f"peer_{dtype}.log")
    env = _peer_env(lighthouse_addr, rounds, dtype, ready)
    if popen is None:
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--peer"],
                env={**os.environ, **env}, cwd=REPO, stdout=log,
                stderr=subprocess.STDOUT)
    else:
        proc = popen(["--peer"], log_path, env)
    proc.peer_dir, proc.peer_log = tmp, log_path
    deadline = time.time() + 300
    while not os.path.exists(ready):
        if proc.poll() is not None or time.time() > deadline:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tail = _tail(log_path)
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError(f"the ring peer never got ready (exit "
                               f"{proc.returncode}):\n{tail}")
        time.sleep(0.05)
    return proc


def _reap_peer(proc: subprocess.Popen) -> None:
    """Kills a peer that still runs, waits for it and removes its
    directory."""
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    shutil.rmtree(proc.peer_dir, ignore_errors=True)


def _tail(path: str, n: int = 3000) -> str:
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError:
        return ""


def _fresh_lighthouse():
    """One lighthouse per bench phase (a reused one would show the
    previous phase's members' ghost heartbeats)."""
    from torchft_tpu_torch import Lighthouse

    return Lighthouse(bind="[::]:0", min_replicas=1, join_timeout_ms=5000,
                      quorum_tick_ms=50)


def _measure_transfer(device, size_mb: int = 16) -> tuple:
    """(d2h_MBps, h2d_MBps) of a ``size_mb`` f32 tensor through pageable
    host memory, as bench.py's ``np.asarray`` reads it."""
    probe = torch.ones(size_mb << 18, dtype=torch.float32, device=device) + 0
    _barrier(probe)
    t0 = time.perf_counter()
    host = probe.to("cpu", copy=True)
    d2h_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = host.to(device, copy=True)
    _barrier(back)
    h2d_s = time.perf_counter() - t0
    return size_mb / d2h_s, size_mb / h2d_s


@contextmanager
def _ring_session(tag: str, wire: str, state=None, timeout_s: int = 600,
                  device="cpu", popen=None, **manager_kwargs):
    """The one 2-member-ring measurement lifecycle every phase shares:
    fresh lighthouse, paced zero peer (rounds=0: it runs until reaped),
    HostCollectives, Manager on ``device``; torn down in reverse with the
    peer reaped first. Yields ``(manager, collectives)``."""
    from torchft_tpu_torch import HostCollectives, Manager

    lh = peer_proc = manager = collectives = None
    try:
        lh = _fresh_lighthouse()
        peer_proc = _spawn_peer(lh.address(), 0, wire, popen)
        collectives = HostCollectives(timeout=timedelta(seconds=timeout_s))
        manager = Manager(
            collectives=collectives,
            load_state_dict=state.load_state_dict if state else None,
            state_dict=state.state_dict if state else None,
            min_replica_size=1,
            timeout=timedelta(seconds=timeout_s),
            quorum_timeout=timedelta(seconds=timeout_s),
            rank=0,
            world_size=1,
            lighthouse_addr=lh.address(),
            replica_id=f"bench_main_{tag}",  # sorts before bench_peer
            device=device,
            **manager_kwargs,
        )
        yield manager, collectives
    except BaseException:
        if peer_proc is not None:
            _mark(f"{tag}: failed; the peer's log:\n{_tail(peer_proc.peer_log)}")
        raise
    finally:
        if peer_proc is not None:
            _reap_peer(peer_proc)
        if manager is not None:
            manager.shutdown()
        if collectives is not None:
            collectives.shutdown()
        if lh is not None:
            lh.shutdown()


class _DilocoHarness:
    """Shared AsyncDiLoCo measurement harness (bench.py's): fresh
    lighthouse + zero peer + manager, manual wall-clock windows
    (``sync_every`` unreachably high; :meth:`window` runs time-boxed inner
    steps and closes with an explicit sync), sized from this run's
    measured warm sync. Outer optimizer ``SGD(0.7, momentum=0.9,
    nesterov=True)``."""

    def __init__(self, state, train_step, batch, wire: str, overlap: bool,
                 tag: str, device="cpu", popen=None):
        from torchft_tpu_torch import SGD, AsyncDiLoCo

        self.state = state
        self.train_step = train_step
        self.batch = batch
        self.loss = None
        self.commits: list = []  # each sync's commit, in order
        self._stack = ExitStack()
        try:
            self.manager, self.collectives = self._stack.enter_context(
                _ring_session(tag, wire, device=device, popen=popen,
                              use_async_quorum=False))
            self.diloco = AsyncDiLoCo(
                self.manager, state, SGD(0.7, momentum=0.9, nesterov=True),
                sync_every=1 << 30,  # wall-clock-boxed windows; see sync()
                compress=wire, overlap=overlap)
            self.manager._load_state_dict = self.diloco.load_state_dict
            self.manager._user_state_dict = self.diloco.state_dict
        except BaseException:
            self._stack.close()  # never leak the paced peer
            raise

    def _run_step(self):
        self.state.params, self.state.opt_state, self.loss = self.train_step(
            self.state.params, self.state.opt_state, self.batch)
        self.diloco.step_applied()

    def _drain(self):
        float(self.loss)

    def _sync(self):
        self.diloco.sync()
        self.diloco.flush()
        if not self.diloco.last_sync_commit:
            _not_committed(self.manager, "diloco sync")
        self.commits.append(True)

    def warm(self, steps: int = 17) -> float:
        """Warms the inner step, then times two syncs and returns the
        second (the first carries the sync path's own first-call costs).
        Each is launch + finish: the conservative sizing input."""
        for i in range(steps):
            self._run_step()
            if i % 16 == 15:
                self._drain()
        _barrier(self.state.params)
        sync_s = 0.0
        for _ in range(2):
            t0 = time.perf_counter()
            self._sync()
            _barrier(self.state.params)
            sync_s = time.perf_counter() - t0
        return sync_s

    def window(self, budget_s: float, rate_hint=None,
               max_steps: int = 1 << 30) -> dict:
        """One timed window: inner steps for ~budget_s (at most
        ``max_steps``), then the boundary sync, all inside the clock."""
        t0 = time.perf_counter()
        n, _ = _timed_window(self._run_step, self._drain, budget_s,
                             max_steps=max_steps, rate_hint=rate_hint)
        self._sync()  # finishes any pending window first
        _barrier(self.state.params)
        el = time.perf_counter() - t0
        return {"steps": n, "elapsed_s": el, "steps_per_sec": n / el,
                "committed": self.commits[-1]}

    def close(self):
        self._stack.close()


def _card_name(device) -> "str | None":
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else None


def card() -> dict:
    """The card's name and power limit as nvidia-smi gives them (None on a
    host without one): ``{"smi": line, "name": name}``."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {"smi": None, "name": None}
    return {"smi": line, "name": line.split(",")[0].strip()}


def _matmul_tflops(device, n: int = 8192, iters: int = 20) -> "float | None":
    """The card's measured bf16 matmul ceiling: an n^3 product timed over
    ``iters`` launches between CUDA events after a warm-up. None off the
    card (not measured)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    gen = torch.Generator(device=device).manual_seed(1)
    a, b = (torch.randn((n, n), generator=gen, device=device,
                        dtype=torch.bfloat16) for _ in range(2))
    for _ in range(3):
        a @ b
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        a @ b
    end.record()
    torch.cuda.synchronize(device)
    return 2 * n ** 3 * iters / (start.elapsed_time(end) / 1e3) / 1e12


def _mfu(cfg, batch, n_params: int, sps: float, device) -> dict:
    """Param FLOPs (6 N tokens) plus causal attention (forward 4 B S^2
    d / 2 a layer, backward ~2.5x forward: x3.5, bench.py's count) at
    ``sps`` steps/s, against the card's datasheet bf16 rate (None for a
    card not in DATASHEET_BF16) and its measured 8192^3 bf16 matmul."""
    B, S_in = batch.shape[0], batch.shape[1] - 1  # the LM drops a token
    attn_tflop = cfg.n_layers * 3.5 * 4 * B * S_in * S_in * cfg.d_model / 2 / 1e12
    param_tflop = 6 * n_params * batch.numel() / 1e12
    total = (param_tflop + attn_tflop) * sps
    peak = DATASHEET_BF16.get(_card_name(device))
    matmul = _matmul_tflops(device)
    return {
        "attn_tflop_per_step": round(attn_tflop, 2),
        "total_tflop_per_step": round(param_tflop + attn_tflop, 2),
        "raw_total_tflops": round(total, 1),
        "card": _card_name(device),
        "mfu_pct_of_datasheet_bf16": None if peak is None
        else round(total * 1e12 / peak * 100, 1),
        "matmul_tflops_measured": None if matmul is None else round(matmul, 1),
        "mfu_pct_of_measured_matmul": None if matmul is None
        else round(total / matmul * 100, 1),
        "note": "total = param matmuls + causal attention (x3.5 fwd+bwd, "
        "bench.py's count); datasheet = the card's dense bf16 rate "
        "(989 TFLOP/s for an H100 SXM5 at 700 W); measured = an 8192^3 "
        "bf16 matmul on this card in this run",
    }


def _bench_big(save, d2h_MBps: float, device) -> dict:
    """Raw vs AsyncDiLoCo on the flash cell's LM: best-of-2 on both
    sides, time-boxed windows sized from the measured warm sync. ``save``
    receives partial results as sub-phases land."""
    import dataclasses

    from torchft_tpu_torch import AdamW, FTTrainState
    from torchft_tpu_torch.models.transformer import init_params, make_train_step

    cfg, batch, _ = _model_setup("big", device)
    tx = AdamW(1e-3)
    BF16_PARAMS = True  # f32 master + bf16 compute copy
    n_params = _n_params(cfg)
    fns: dict = {}
    errors: dict = {}

    def step_fn_for(c):
        if c not in fns:
            fns[c] = make_train_step(c, tx, bf16_params=BF16_PARAMS)
        return fns[c]

    def time_raw_variant(c, warm: int, budget_s: float = _win(25.0)):
        """steps/s, or None when the variant runs out of the card's
        memory (dense attention's S^2 scores): the selection then takes
        the survivor, and the error is recorded."""
        try:
            return _time_raw_loop(step_fn_for(c), lambda: init_params(c, 0, device),
                                  tx, batch, warm, budget_s, rate_hint=4.0)
        except torch.cuda.OutOfMemoryError as e:
            name = "flash" if c.use_flash else "dense"
            errors[name] = f"{type(e).__name__}: {str(e)[:200]}"
            _mark(f"big: {name} variant failed: {errors[name]}")
            if device.type == "cuda":
                torch.cuda.empty_cache()
            return None

    _mark("big: flash raw probe")
    flash_cfg = dataclasses.replace(cfg, use_flash=True)
    flash_sps = time_raw_variant(flash_cfg, 2)
    dense_sps = None
    if flash_sps is None or (
            _remaining(420) > 0 and not os.environ.get("BENCH_SKIP_DENSE")):
        _mark("big: dense raw probe")
        dense_sps = time_raw_variant(dataclasses.replace(cfg, use_flash=False), 2)
    if dense_sps is None and flash_sps is None:
        raise RuntimeError(f"both attention variants failed to run: {errors}")
    cfg = flash_cfg if (flash_sps or 0) >= (dense_sps or 0) else \
        dataclasses.replace(cfg, use_flash=False)
    _mark(f"big: dense {dense_sps} vs flash {flash_sps} steps/s -> "
          f"{'flash' if cfg.use_flash else 'dense'}")
    attention = {
        "dense": None if dense_sps is None else round(dense_sps, 3),
        "flash": None if flash_sps is None else round(flash_sps, 3),
    }
    save({"params_M": round(n_params / 1e6, 1), "bf16_params": BF16_PARAMS,
          "attention": "flash" if cfg.use_flash else "dense",
          "attention_raw_steps_per_sec": attention,
          "attention_errors": dict(errors)})
    train_step = step_fn_for(cfg)
    raw_sps = max(s for s in (dense_sps, flash_sps) if s is not None)
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the unselected variant's cache

    os.environ["BENCH_MODEL"] = "big"
    harness = None
    window_sps, windows_steps, commits = [], [], []
    raw_remeasured = False
    skipped = None
    try:
        wire = _env_wire() or ("bf16" if d2h_MBps >= 100 else "int8")
        harness = _DilocoHarness(
            FTTrainState(init_params(cfg, 0, device), tx), train_step, batch,
            wire, overlap=d2h_MBps >= 100, tag="big", device=device)
        _mark("big: warm + timed sync")
        sync_s = harness.warm()
        win_s = _win(min(max(14.0 * sync_s, 40.0), 120.0))
        _mark(f"big: sync {sync_s:.1f}s -> window {win_s:.0f}s")
        for w in range(2):
            need = win_s + 2 * sync_s + 10
            if _remaining(90) < need:
                skipped = f"window {w} skipped (time budget)"
                _mark(f"big: {skipped}")
                break
            res = harness.window(win_s, rate_hint=raw_sps)
            window_sps.append(res["steps_per_sec"])
            windows_steps.append(res["steps"])
            commits.append(res["committed"])
            _mark(f"big: window {w}: {res['steps']} steps "
                  f"{res['steps_per_sec']:.2f}/s")
            save({"window_steps_per_sec": [round(s, 3) for s in window_sps],
                  "window_steps": windows_steps, "sync_s": round(sync_s, 2),
                  "raw_steps_per_sec": round(raw_sps, 3)})
        if not window_sps:
            raise RuntimeError("no big FT window fit the budget")
        if harness.collectives.size() != 2:
            raise RuntimeError("the big phase's peer did not join the ring")
        if _remaining(60) > 30:
            # symmetric noise treatment: FT best-of-2 vs raw best-of-2
            _mark("big: raw re-measure")
            raw2 = time_raw_variant(cfg, 1)
            if raw2 is not None:
                raw_sps = max(raw_sps, raw2)
                raw_remeasured = True
    finally:
        os.environ.pop("BENCH_MODEL", None)
        if harness is not None:
            harness.close()
    ft_sps = max(window_sps)
    # best-of-N vs best-of-N; when the budget cut a side short,
    # first-vs-first rather than biasing the ratio FT-ward
    symmetric = raw_remeasured and len(window_sps) == 2
    ft_for_ratio = ft_sps if raw_remeasured else window_sps[0]
    param_tflop = 6 * n_params * batch.numel() / 1e12
    result = {
        "params_M": round(n_params / 1e6, 1),
        "bf16_params": BF16_PARAMS,
        "tflop_per_step": round(param_tflop, 2),
        "attention": "flash" if cfg.use_flash else "dense",
        "attention_raw_steps_per_sec": attention,
        "attention_errors": errors,
        "raw_steps_per_sec": round(raw_sps, 3),
        "raw_tflops": round(param_tflop * raw_sps, 1),
        "ft_diloco_steps_per_sec": round(ft_sps, 3),
        "window_steps_per_sec": [round(s, 3) for s in window_sps],
        "window_steps": windows_steps,
        "window_committed": commits,
        "sync_s": round(sync_s, 2),
        "compress": wire,
        "ratio_vs_raw": round(min(ft_for_ratio / raw_sps, 1.0), 3),
        "ratio_raw_measurement": round(ft_for_ratio / raw_sps, 3),
        "ratio_symmetric": symmetric,
        "windows_measured": len(window_sps),
        "mfu": _mfu(cfg, batch, n_params, raw_sps, device),
        "note": "the flash cell's LM; wall-clock-boxed windows sized from "
        "this run's measured warm sync (14x), boundary sync inside the "
        "window clock" + (f"; {skipped}" if skipped else ""),
    }
    save(result)
    return result


def _bench_big2(device) -> dict:
    """One raw MFU point at higher arithmetic intensity (d_model 2048,
    head_dim 128: K4/K5 at D 128). No FT machinery."""
    from torchft_tpu_torch import AdamW
    from torchft_tpu_torch.models.transformer import init_params, make_train_step

    cfg, batch, _ = _model_setup("big2", device)
    tx = AdamW(1e-3)
    n_params = _n_params(cfg)
    train_step = make_train_step(cfg, tx, bf16_params=True)
    sps = _time_raw_loop(train_step, lambda: init_params(cfg, 0, device), tx,
                         batch, 2, _win(45.0), rate_hint=1.5)
    param_tflop = 6 * n_params * batch.numel() / 1e12
    return {
        "params_M": round(n_params / 1e6, 1),
        "d_model": cfg.d_model,
        "head_dim": cfg.d_model // cfg.n_heads,
        "batch": int(batch.shape[0]),
        "raw_steps_per_sec": round(sps, 3),
        "param_tflop_per_step": round(param_tflop, 2),
        "raw_param_tflops": round(param_tflop * sps, 1),
        "mfu": _mfu(cfg, batch, n_params, sps, device),
        "note": "raw-only MFU point at d_model 2048 / head_dim 128",
    }


def _not_committed(manager, what: str) -> None:
    """A healthy bench run commits every step: one that did not is the
    phase's error (a mismatched peer would otherwise fail step after
    step until the ring's timeout)."""
    raise RuntimeError(f"{what}: a step did not commit "
                       f"({manager.errored()!r})")


def _record_commit(commits: list, ddp, manager, what: str) -> None:
    """Appends the settle a ``PipelinedDDP`` step or flush just made (a
    pipelined step settles the one before it) and clears it; raises on
    a discarded step."""
    if ddp.last_commit is None:
        return
    if not ddp.last_commit:
        _not_committed(manager, what)
    commits.append(True)
    ddp.last_commit = None


def _ddp_small_session(cfg, tx, grad_fn, batch, budget_s: float,
                       max_steps: int, tag: str, device,
                       params=None) -> dict:
    """One live 2-member ring session of ``PipelinedDDP(compress="int8",
    transport="legacy")`` (the managed allgather of ``{q, scale}``:
    K1a/K1b, K2; bench.py's PipelinedDDP default transport): one warm
    step, then a time-boxed window. ``params``: the initial parameters
    (default seed 0's). Returns steps, seconds, the op stats, the
    manager's metrics, each step's commit and the final state."""
    from torchft_tpu_torch import FTTrainState, PipelinedDDP

    state = FTTrainState(_grad_params(cfg, device, params), tx)
    with _ring_session(tag, "int8", state, device=device) as (
            manager, collectives):
        ddp = PipelinedDDP(manager, state, grad_fn, compress="int8",
                           transport="legacy")
        commits, participants = [], []

        def step():
            ddp.step(batch)
            _record_commit(commits, ddp, manager, tag)
            participants.append(manager.num_participants())

        step()  # warm: first calls + peer round 0
        _barrier(state.params)
        collectives.pop_op_stats()
        t0 = time.perf_counter()
        n, _ = _timed_window(
            step, lambda: None,  # ddp.step blocks on each settle
            budget_s, max_steps=max_steps,
            # second-scale steps: the clock per step (a hint below 1/3)
            rate_hint=0.15)
        ddp.flush()
        _record_commit(commits, ddp, manager, tag)
        _barrier(state.params)
        el = time.perf_counter() - t0
        ops = collectives.pop_op_stats()[-max_steps:]
        snap = manager.metrics().snapshot()
        size = collectives.size()
    if size != 2:
        raise RuntimeError(f"{tag}: the peer did not join the ring")
    return {"steps": n, "elapsed_s": el, "ops": ops, "metrics": snap,
            "commits": commits, "ring_size": size,
            "participants": participants, "state": state}


def _bench_ddp_small(raw_hint: float, device) -> dict:
    """Per-step fault-tolerant DDP at a link-sized scale, on the card
    every run (bench.py's): a live probe measures the per-step FT
    overhead, the batch is sized so compute covers ~1.3x it, then >= 20
    timed steps (time permitting) with the per-phase breakdown."""
    from torchft_tpu_torch import AdamW
    from torchft_tpu_torch.models.transformer import (init_params,
                                                      make_grad_fn,
                                                      make_train_step)

    wire = "int8"
    os.environ["BENCH_MODEL"] = "ddp_small"
    try:
        cfg, batch, _ = _model_setup("ddp_small", device)
        tx = AdamW(1e-3)
        n_params = _n_params(cfg)
        wire_mb = n_params / 1e6  # int8: 1 byte/param
        train_step = make_train_step(cfg, tx)
        grad_fn = make_grad_fn(cfg)
        base_B = batch.shape[0]
        _mark("ddp_small: raw probe")
        raw_sps = _time_raw_loop(train_step, lambda: init_params(cfg, 0, device),
                                 tx, batch, 2, _win(12.0), rate_hint=raw_hint)
        c_base = 1.0 / raw_sps
        _mark("ddp_small: live FT probe")
        probe = _ddp_small_session(cfg, tx, grad_fn, batch, _win(20.0), 6,
                                   "ddp_probe", device)
        t_ft_probe = probe["elapsed_s"] / max(probe["steps"], 1)
        overhead = max(t_ft_probe - c_base, 0.0)
        # compute ~= 1.3x the measured overhead (pipelined ratio ~
        # C / max(C, R)); cap 512
        want_B = int(base_B * max(1.3 * overhead / c_base, 1.0))
        B = min(max(32, (want_B // 32) * 32), 512)
        _mark(f"ddp_small: probe {t_ft_probe:.2f}s/step (compute "
              f"{c_base:.2f}s, overhead {overhead:.2f}s) -> B={B}")
        if B != base_B:
            os.environ["BENCH_DDP_SMALL_BATCH"] = str(B)
            _, batch, _ = _model_setup("ddp_small", device)
            raw_sps = _time_raw_loop(
                train_step, lambda: init_params(cfg, 0, device), tx, batch, 1,
                _win(12.0), rate_hint=raw_sps * base_B / B)
        t_step_est = c_base * B / base_B + overhead
        budget = min(max(_win(40.0), 24 * t_step_est), _win(110.0))
        budget = min(budget, max(_remaining(120), _win(30.0)))
        _mark(f"ddp_small: timed run (B={B}, budget {budget:.0f}s)")
        run = _ddp_small_session(cfg, tx, grad_fn, batch, budget, 64,
                                 "ddp_small", device)
        ft_sps = run["steps"] / run["elapsed_s"]
        agg: dict = {}
        for s in run["ops"]:
            for k in ("pack", "d2h", "ring", "h2d"):
                if k in s:
                    agg.setdefault(k, []).append(s[k])
        med = {k: round(sorted(v)[len(v) // 2], 4) for k, v in agg.items()}
        timers = run["metrics"].get("timers_s", {})
        breakdown = {
            "compute_s_per_step": round(1.0 / raw_sps, 4),
            "collectives_median_s": med,
            "quorum_p50_s": timers.get("quorum", {}).get("p50"),
            "vote_p50_s": timers.get("commit_vote", {}).get("p50"),
            "allgather_p50_s": timers.get("allgather", {}).get("p50"),
            "probe_s_per_step": round(t_ft_probe, 4),
        }
        return {
            "steps_per_sec": round(ft_sps, 3),
            "raw_steps_per_sec": round(raw_sps, 3),
            "ratio_vs_raw": round(min(ft_sps / raw_sps, 1.0), 3),
            "ratio_raw_measurement": round(ft_sps / raw_sps, 3),
            "timed_steps": run["steps"],
            "all_committed": all(run["commits"]),
            "params_M": round(n_params / 1e6, 2),
            "wire": wire,
            "wire_MB": round(wire_mb, 2),
            "batch": int(batch.shape[0]),
            "tokens_per_step": int(batch.numel()),
            "measured_overhead_s": round(overhead, 3),
            "breakdown": breakdown,
            "note": "link-sized per-step DDP (PipelinedDDP int8 on the "
            "legacy transport, full quorum + commit vote every step) over a "
            "live 2-member ring; batch sized so compute covers 1.3x the "
            "measured per-step FT overhead (live probe); raw baseline is "
            "the fused one-program step at the same batch; breakdown = "
            "per-phase medians over the timed steps",
        }
    finally:
        os.environ.pop("BENCH_MODEL", None)
        os.environ.pop("BENCH_DDP_SMALL_BATCH", None)


def _ft_ddp_session(mode: str, wire: str, cfg, tx, grad_fn, ddp_batch,
                    budget_s: float, device, popen=None,
                    max_steps: int = 1 << 30, params=None) -> dict:
    """One per-step DDP session of the flagship-scale phase: ``blocking``
    (``OptimizerWrapper`` + ``manager.allreduce``) or ``pipelined``
    (``PipelinedDDP`` on the legacy transport, bench.py's default; bf16 on
    a degraded link), one warm step, then a time-boxed window. ``params``:
    the initial parameters (default seed 0's). Returns steps/s, each
    step's commit and the final state."""
    from torchft_tpu_torch import FTTrainState, OptimizerWrapper, PipelinedDDP

    state = FTTrainState(_grad_params(cfg, device, params), tx)
    commits, participants = [], []
    with _ring_session(f"ddp_{mode}", wire, state, device=device,
                       popen=popen) as (manager, collectives):
        if mode == "blocking":
            optimizer = OptimizerWrapper(manager, state)

            def ft_step():
                optimizer.zero_grad()
                _, grads = grad_fn(state.params, ddp_batch)
                avg = manager.allreduce(grads).wait()
                if not optimizer.step(avg):
                    _not_committed(manager, f"ddp_{mode}")
                commits.append(True)
                participants.append(manager.num_participants())

            ft_step()  # warm (peer round 0)
            _barrier(state.params)
            t0 = time.perf_counter()
            n, _ = _timed_window(
                ft_step, lambda: _barrier(state.params), budget_s,
                max_steps=max_steps,
                # each step blocks on a full-gradient ring pass: a short
                # first burst, then the observed rate
                rate_hint=1.0)
            _barrier(state.params)
            el = time.perf_counter() - t0
        else:
            ddp = PipelinedDDP(manager, state, grad_fn,
                               compress="bf16" if wire == "bf16" else None,
                               transport="legacy")

            def ft_step():
                ddp.step(ddp_batch)
                _record_commit(commits, ddp, manager, f"ddp_{mode}")
                participants.append(manager.num_participants())

            ft_step()  # warm dispatch (peer round 0)
            _barrier(state.params)
            # the flush (step N's settle) is inside the clock
            t0 = time.perf_counter()
            n, _ = _timed_window(ft_step, lambda: None, budget_s,
                                 max_steps=max_steps, rate_hint=1.0)
            ddp.flush()
            _record_commit(commits, ddp, manager, f"ddp_{mode}")
            _barrier(state.params)
            el = time.perf_counter() - t0
        size = collectives.size()
    # a real 2-member ring carried every byte
    if size != 2:
        raise RuntimeError(f"ddp_{mode}: the peer did not join the ring")
    return {"steps_per_sec": n / el, "steps": n, "commits": commits,
            "ring_size": size, "participants": participants, "state": state}


def _run_ft_ddp_phase(cfg, batch, tx, train_step, raw_sps, on_card, d2h_MBps,
                      device) -> dict:
    """Flagship-scale per-step gradient allreduce over a real 2-group
    ring, against its own raw baseline at the same batch (bench.py's
    ``_run_ft_ddp_phase``): blocking and pipelined both recorded; on the
    CPU both the 4x-token batch and the reference-like small batch. Raw
    and FT loops share the same time-boxed windows and drains."""
    from torchft_tpu_torch.models.transformer import init_params, make_grad_fn

    degraded = on_card and d2h_MBps < 100
    grad_fn = make_grad_fn(cfg)
    win_s = _win(12.0 if not on_card else (20.0 if degraded else 15.0))

    def time_ddp_raw(ddp_batch, warm: int) -> float:
        return _time_raw_loop(train_step, lambda: init_params(cfg, 0, device),
                              tx, ddp_batch, warm, win_s, rate_hint=raw_sps)

    wire = "bf16" if degraded else "f32"
    all_committed = []

    def run_ddp(mode, ddp_batch):
        res = _ft_ddp_session(mode, wire, cfg, tx, grad_fn, ddp_batch, win_s,
                              device)
        all_committed.append(all(res["commits"]))
        return res["steps_per_sec"]

    def measure_point(ddp_batch) -> dict:
        ddp_raw = max(time_ddp_raw(ddp_batch, 1), time_ddp_raw(ddp_batch, 0))
        blocking = None if degraded else run_ddp("blocking", ddp_batch)
        pipe = run_ddp("pipelined", ddp_batch)
        best = max(s for s in (blocking, pipe) if s is not None)
        return {
            "steps_per_sec": round(best, 3),
            "ratio_vs_raw": round(min(best / ddp_raw, 1.0), 3),
            "ratio_raw_measurement": round(best / ddp_raw, 3),
            "raw_steps_per_sec": round(ddp_raw, 3),
            "blocking_steps_per_sec": None if blocking is None
            else round(blocking, 3),
            "pipelined_steps_per_sec": round(pipe, 3),
            "tokens_per_step": int(ddp_batch.numel()),
        }

    big_batch = batch if on_card else torch.cat([batch] * 4, dim=0)
    out = measure_point(big_batch)
    out["wire"] = wire
    out["note"] = (
        "per-step full-gradient shipping over a live 2-member ring; raw "
        "baseline best-of-2 at the same batch with identical time-boxed "
        "windows and drain amortization (ratio clamped at 1.0; the raw "
        "measurement ratio is recorded unclamped)"
        + ("; degraded device<->host link: the absolute rate is "
           "link-bound" if degraded else ""))
    if not on_card:
        # the reference-like small batch: fixed ring work is not amortized
        out["small_batch"] = measure_point(batch)
        out["note"] += ("; small_batch = the reference-like batch where "
                        "ring work is not amortized")
    out["all_committed"] = all(all_committed)
    return out


def _land_headline(detail: dict, out_path, ft_sps: float,
                   raw_sps: float) -> None:
    """Writes the detail (to ``out_path``, if any) and prints a metric
    line now: the last metric line is the result, so a wedge later cannot
    lose this one."""
    _write(detail, out_path)
    print(json.dumps({
        "metric": "steps_per_sec_ft",
        "value": round(ft_sps, 3),
        "unit": "steps/s",
        "vs_baseline": round(min(ft_sps / raw_sps, 1.0) / 0.90, 3),
        **_metric_platform_fields(),
    }), flush=True)


def _write(detail: dict, out_path) -> None:
    if out_path:
        with open(out_path, "w") as f:
            json.dump(detail, f, indent=2)


def _phase_errors(detail: dict) -> list:
    return [k for k, v in detail.items()
            if isinstance(v, dict) and "error" in v]


def run(device, out_path=None) -> dict:
    """The measurement: every phase in bench.py's order on ``device``
    (the card-only phases on a card), each headline printed as it lands.
    A phase's error is recorded as ``{"error": ...}``. Returns the
    detail."""
    import faulthandler

    from torchft_tpu_torch import AdamW, FTTrainState
    from torchft_tpu_torch.models.transformer import init_params, make_train_step

    global _window_scale
    _window_scale = (min(1.0, _BUDGET_S / 1000.0)
                     if torch.device(device).type == "cpu" else 1.0)
    # init watchdog: a hang before the first measurement kills the
    # process; then a non-fatal periodic stack dump
    faulthandler.dump_traceback_later(
        float(os.environ.get("BENCH_INIT_WATCHDOG_S", "300")), repeat=False,
        exit=True)
    cfg, batch, on_card = _model_setup(device=device)
    # ring peers (spawned with the BENCH_* env) must pack identical trees
    os.environ["BENCH_FORCE_LAYERS"] = str(cfg.n_layers)
    tx = AdamW(1e-3)
    # the fused step is the raw baseline AND the diloco inner step
    train_step = make_train_step(cfg, tx)
    faulthandler.cancel_dump_traceback_later()
    detail: dict = {"host": {"cpus": os.cpu_count(),
                             "platform": _METRIC_PLATFORM or device.type,
                             "device": str(device), "card": card()["smi"],
                             "budget_s": _BUDGET_S,
                             "window_scale": _window_scale}}
    faulthandler.dump_traceback_later(300, repeat=True, exit=False)

    def time_raw(warm: int, budget_s: float = _win(35.0), hint=None) -> float:
        return _time_raw_loop(train_step, lambda: init_params(cfg, 0, device),
                              tx, batch, warm, budget_s, rate_hint=hint)

    _mark("phase: raw (first calls + timed loop)")
    raw_sps = time_raw(5)
    detail["raw"] = {"steps_per_sec": round(raw_sps, 3)}
    _mark(f"phase: transfer probe (raw={raw_sps:.1f} steps/s)")
    d2h_MBps, h2d_MBps = _measure_transfer(device, 16)
    detail["transfer"] = {"d2h_MBps": round(d2h_MBps, 1),
                          "h2d_MBps": round(h2d_MBps, 1)}
    n_params = _n_params(cfg)
    grad_mb = n_params * 4 / 1e6
    force_ddp = os.environ.get("BENCH_FORCE_DDP") == "1" or (
        os.environ.get("BENCH_WIRE") == "ddp")

    # -- ft_diloco: the provisional headline lands after the first window
    _mark("phase: ft_diloco")
    overlap = d2h_MBps >= 100
    if not overlap:
        # a degraded link: serialize the ring transfers on both members
        # (the env flows to the peer)
        os.environ["TORCHFT_HC_PIPELINE_CHUNKS"] = "1"
    wire = _env_wire() or ("bf16" if overlap else "int8")
    harness = _DilocoHarness(FTTrainState(init_params(cfg, 0, device), tx),
                             train_step, batch, wire, overlap, tag="diloco",
                             device=device)
    windows = []
    try:
        _mark("diloco: warm + timed sync")
        sync_s = harness.warm()
        win_s = _win(min(max(14.0 * sync_s, 30.0), 120.0))
        _mark(f"diloco: sync {sync_s:.1f}s -> window {win_s:.0f}s")
        window2_margin = 240 if on_card else 150
        for w in range(2):
            if w and _remaining(window2_margin) < win_s + 2 * sync_s:
                _mark("diloco: window 1 skipped (time budget)")
                detail["ft_diloco"]["skipped_window_1"] = "time budget"
                break
            res = harness.window(win_s, rate_hint=raw_sps)
            windows.append(res)
            _mark(f"diloco: window {w}: {res['steps']} steps "
                  f"{res['steps_per_sec']:.1f}/s")
            if w == 0:
                ft_sps = res["steps_per_sec"]
                detail["ft_diloco"] = {
                    "steps_per_sec": round(ft_sps, 3),
                    "window_steps_per_sec": [round(ft_sps, 3)],
                    "window_steps": [res["steps"]],
                    "sync_s": round(sync_s, 2),
                    "ratio_vs_raw": round(ft_sps / raw_sps, 3),
                    "compress": wire,
                    "overlap": overlap,
                }
                # the provisional headline only off a formed ring
                if (harness.collectives.size() == 2
                        and harness.manager.num_participants() >= 2):
                    _land_headline(detail, out_path, ft_sps, raw_sps)
                else:
                    _mark("diloco: window-0 headline withheld (ring not "
                          f"formed: size={harness.collectives.size()} "
                          f"participants={harness.manager.num_participants()})")
        ring_size = harness.collectives.size()
        if ring_size != 2:
            raise RuntimeError("the diloco peer did not join the ring")
        commits = list(harness.commits)
    finally:
        harness.close()
    ft_sps = max(r["steps_per_sec"] for r in windows)
    detail["ft_diloco"].update({
        "steps_per_sec": round(ft_sps, 3),
        "window_steps_per_sec": [round(r["steps_per_sec"], 3) for r in windows],
        "window_steps": [r["steps"] for r in windows],
        "sync_committed": commits,
        "ring_size": ring_size,
        "note": f"{wire} pseudogradient window sync (AsyncDiLoCo); "
        "wall-clock-boxed windows sized at 14x this run's measured warm "
        "sync; best of the measured windows; boundary sync inside every "
        "window's clock",
    })

    # symmetric noise treatment: best-of-2 raw against best-of-N windows
    raw_remeasured = False
    if _remaining(240) > _win(35) or not on_card:
        _mark("phase: raw re-measure")
        raw_again = time_raw(1, hint=raw_sps)
        detail["raw"]["steps_per_sec_2nd"] = round(raw_again, 3)
        raw_sps = max(raw_sps, raw_again)
        raw_remeasured = True
    detail["raw"]["best"] = round(raw_sps, 3)
    ft_for_ratio = ft_sps if raw_remeasured else windows[0]["steps_per_sec"]
    detail["ft_diloco"]["ratio_vs_raw"] = round(min(ft_for_ratio / raw_sps, 1.0), 3)
    detail["ft_diloco"]["ratio_raw_measurement"] = round(ft_for_ratio / raw_sps, 3)
    _land_headline(detail, out_path, ft_for_ratio, raw_sps)

    # -- per-step FT at the link-sized scale: on the card every run
    if on_card and _remaining(150) > 60:
        _mark("phase: ft_ddp_small")
        try:
            detail["ft_ddp_small"] = _bench_ddp_small(raw_sps, device)
        except Exception as e:  # noqa: BLE001 - recorded; the run exits 1
            _mark(f"ft_ddp_small failed: {type(e).__name__}: {e}")
            detail["ft_ddp_small"] = {"error": f"{type(e).__name__}: {e}"}
        _land_headline(detail, out_path, ft_for_ratio, raw_sps)
    elif on_card:
        detail["ft_ddp_small"] = {"skipped": "time budget"}

    # -- ft_ddp at the dense model
    _mark(f"phase: ft_ddp flagship (d2h={d2h_MBps:.1f} MB/s)")
    if (not on_card and _remaining(30) > 150) or (
            on_card and (d2h_MBps >= 100 or force_ddp) and _remaining(200) > 90):
        try:
            detail["ft_ddp"] = _run_ft_ddp_phase(
                cfg, batch, tx, train_step, raw_sps, on_card, d2h_MBps,
                device)
        except Exception as e:  # noqa: BLE001 - recorded; the run exits 1
            _mark(f"ft_ddp failed: {type(e).__name__}: {e}")
            detail["ft_ddp"] = {"error": f"{type(e).__name__}: {e}"}
    elif d2h_MBps < 100 and not force_ddp:
        detail["ft_ddp"] = {
            "skipped": f"device<->host link degraded ({d2h_MBps:.1f} MB/s "
            f"d2h); per-step shipping of {grad_mb:.0f} MB grads is "
            "link-bound; set BENCH_FORCE_DDP=1 to record it"}
    else:
        detail["ft_ddp"] = {"skipped": "time budget"}
    _land_headline(detail, out_path, ft_for_ratio, raw_sps)

    # -- big: its ratio is the last headline
    if on_card and not os.environ.get("BENCH_SKIP_BIG"):
        if _remaining(120) < 260:
            detail["big"] = {"skipped": "time budget"}
        else:
            def save_partial(partial: dict) -> None:
                detail["big"] = {**(detail.get("big") or {}), **partial}
                _write(detail, out_path)

            _mark("phase: big")
            try:
                _bench_big(save_partial, d2h_MBps, device)
            except Exception as e:  # noqa: BLE001 - recorded; the run exits 1
                _mark(f"big failed: {type(e).__name__}: {e}")
                save_partial({"error": f"{type(e).__name__}: {e}"})
            big = detail.get("big") or {}
            if "error" not in big and big.get("ft_diloco_steps_per_sec"):
                detail["headline"] = "big"
                _write(detail, out_path)
                print(json.dumps({
                    "metric": "steps_per_sec_ft",
                    "value": big["ft_diloco_steps_per_sec"],
                    "unit": "steps/s",
                    "vs_baseline": round(big["ratio_vs_raw"] / 0.90, 3),
                    **_metric_platform_fields(),
                }), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    # -- big2: the raw MFU point at head_dim 128
    if on_card:
        if _remaining(60) > 150 and not os.environ.get("BENCH_SKIP_BIG2"):
            _mark("phase: big2 (MFU point)")
            try:
                detail["big2"] = _bench_big2(device)
            except Exception as e:  # noqa: BLE001 - recorded; the run exits 1
                _mark(f"big2 failed: {type(e).__name__}: {e}")
                detail["big2"] = {"error": f"{type(e).__name__}: {e}"}
        else:
            detail.setdefault("big2", {"skipped": "time budget"})
        _write(detail, out_path)
    faulthandler.cancel_dump_traceback_later()
    _mark(f"bench done in {time.monotonic() - _T0:.0f}s")
    return detail


def main(argv=None) -> int:
    import faulthandler

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--peer", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--device", default=None,
                        help="cpu for a CPU rehearsal (default: the card; "
                        "exits 2 without one)")
    parser.add_argument("--out", help="write the detail JSON here")
    args = parser.parse_args(argv)
    if args.peer:
        # peers run whole phases: dump stacks now and then, so a killed
        # run's log names the blocking frame
        faulthandler.dump_traceback_later(300, repeat=True, exit=False)
        peer()
        return 0
    try:
        device = _acquire_backend(args.device)
    except NoCard as e:
        print(f"bench_torch: {e}", file=sys.stderr, flush=True)
        return EXIT_NO_CARD
    detail = run(device, args.out)
    bad = _phase_errors(detail)
    if bad:
        print(f"bench_torch: phases failed: {bad}", file=sys.stderr, flush=True)
        return 1
    return 0


def _supervised(argv) -> int:
    """One measurement attempt in a child with a deadline that fits
    ``BENCH_ATTEMPT_TIMEOUT_S`` (bench.py's supervisor): a retry only when
    the attempt died fast with no metric line and most of the budget
    left, never after a refusal for want of a card. The child's last
    metric line is printed again; its exit code is this one's."""
    deadline_s = int(float(os.environ.get("BENCH_ATTEMPT_TIMEOUT_S", 1000)))
    start = time.monotonic()
    env = dict(os.environ, BENCH_INNER="1")

    def attempt(budget: float) -> tuple:
        env["BENCH_ATTEMPT_TIMEOUT_S"] = str(int(budget))
        # the attempt leads a process group of its own, which its ring
        # peers join: a wedged attempt is killed with its peers and
        # nothing else on the host
        proc = subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), *argv],
            env=env, stdout=subprocess.PIPE, text=True,
            start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=budget + 30)
            return proc.returncode, out
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, _ = proc.communicate()
            print(f"bench_torch attempt wedged past {int(budget)}s",
                  file=sys.stderr, flush=True)
            return 1, out

    def metric_lines(out: str) -> list:
        return [l for l in out.splitlines() if l.startswith('{"metric"')]

    rc, out = attempt(deadline_s)
    if rc != EXIT_NO_CARD and not metric_lines(out):
        remaining = deadline_s - (time.monotonic() - start) - 30
        if remaining > 0.5 * deadline_s:
            print("bench_torch attempt produced no metric early; retrying on "
                  f"the remaining {int(remaining)}s", file=sys.stderr,
                  flush=True)
            rc, out = attempt(remaining)
    lines = metric_lines(out)
    if lines:
        print(lines[-1], flush=True)
    elif rc == 0:
        rc = 1
    return rc


if __name__ == "__main__":
    if os.environ.get("BENCH_INNER") or "--peer" in sys.argv:
        sys.exit(main())
    sys.exit(_supervised(sys.argv[1:]))

"""Shared by the port's experiment scripts (``experiments/*_torch.py``):
the flagship's sizes, the device a run takes, timing of each call by
CUDA events on the card's stream, the card's name and bf16 peak, and the check that holds
every K4/K5 call of a row against its plain version.

The scripts import ``torch``, ``numpy`` and the port, never JAX or the
JAX package. They run on the card unless the caller passes ``--device
cpu``; without a card and without it they raise. A CPU run takes
``--size tiny``: the same code paths at widths a CPU runs in seconds,
whose times say nothing of the card.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from torchft_tpu_torch._device import resolve_device  # noqa: E402,F401
from torchft_tpu_torch.ops import launch_counts, reset_launch_counts  # noqa: E402
# the card's datasheet rate and its nvidia-smi line: one copy, bench_torch's
from bench_torch import DATASHEET_BF16, card  # noqa: E402,F401

# the module (the package's own ``flash_attention`` is the function)
tfa = importlib.import_module("torchft_tpu_torch.ops.flash_attention")

# bench.py's "big" LM, the flagship (experiments/mfu_breakdown.py:38-39)
SIZES = {
    "flagship": dict(vocab_size=8192, d_model=1024, n_heads=16, n_layers=8,
                     d_ff=4096, max_seq_len=2048),
    "tiny": dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                 max_seq_len=64),
}
# (batch, tokens per row) of a step: the model sees S - 1 of them
BATCH = {"flagship": (16, 2048), "tiny": (2, 65)}
# the K4/K5 launches of one layer's forward and backward (K5: dq with
# delta, then dk/dv)
FWD_LAUNCHES, BWD_LAUNCHES = 1, 2


def add_device_args(parser) -> None:
    parser.add_argument("--device", default=None,
                        help="cpu for a CPU rehearsal (default: the card; "
                        "raises without one)")
    parser.add_argument("--size", choices=sorted(SIZES), default="flagship",
                        help="flagship widths, or tiny ones for the CPU")


def drain(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def flash_path(cfg: "tfa.FlashConfig", S: int) -> str:
    """Which masking path a call takes, and whether its last key tile is
    ragged: ``fast`` (block_q == block_k, causal: the finite -1e30 mask)
    or ``general`` (-inf and isfinite guards)."""
    path = "fast" if cfg.fast else "general"
    return path + (" ragged" if S % cfg.block_k else "")


class PlainMismatch(RuntimeError):
    """A K4/K5 call off its plain version past the tolerance."""


# Batch rows a plain call takes at a time (its (S, S) scores stay small).
PLAIN_CHUNK = 2
# The bound on ||got - plain|| / ||plain|| (Frobenius, per output): bf16
# outputs, 2**-6, four times the 2**-8 that rounding both sides' outputs
# to bf16 and the kernel's p to bf16 can reach; f32 (lse, and every
# output of an f32 call), 2e-5, the summation order's as in
# ``plain_tolerance``. Set by typical values, where ``plain_tolerance`` is
# set by the largest one, so rows far smaller than the largest (the deep
# rows of a causal mask) are held too.
REL_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 2e-5}


class PlainCheck:
    """While :meth:`active`, every K4 (``flash_fwd``) and K5
    (``flash_bwd``) call runs as usual, and :meth:`flush` then holds its
    outputs against the plain version on the same inputs (the plain K5
    gets the call's own ``out`` and ``lse`` and the torch ``delta``): the
    largest difference against ``plain_tolerance`` and the relative
    Frobenius difference against ``REL_TOL``. A call past either raises
    :class:`PlainMismatch`; each call's readings go to ``calls``. The
    check launches no kernel (its launch counts are the row's own), and
    ``flush`` runs between calls, so a caller keeps it off the clock."""

    def __init__(self) -> None:
        self.calls: List[dict] = []
        self._pending: List[tuple] = []

    def _hold(self, row: str, kernel: str, cfg, shape, got: dict,
              plain: Callable) -> None:
        err = dict.fromkeys(got, 0.0)
        tol = dict.fromkeys(got, 0.0)
        diff2 = dict.fromkeys(got, 0.0)
        ref2 = dict.fromkeys(got, 0.0)
        for b0 in range(0, shape[0], PLAIN_CHUNK):
            sl = slice(b0, b0 + PLAIN_CHUNK)
            for (name, out), ref in zip(got.items(), plain(sl)):
                part = out[sl]
                if part.dtype != ref.dtype or part.shape != ref.shape:
                    raise PlainMismatch(
                        f"{row} {kernel}: {name} is {part.dtype} "
                        f"{tuple(part.shape)}, plain {ref.dtype} "
                        f"{tuple(ref.shape)}")
                if not torch.isfinite(part).all():
                    raise PlainMismatch(f"{row} {kernel}: non-finite {name}")
                d = part.double() - ref.double()
                err[name] = max(err[name], float(d.abs().max()))
                tol[name] = max(tol[name], tfa.plain_tolerance(name, ref))
                diff2[name] += float(d.square().sum())
                ref2[name] += float(ref.double().square().sum())
        rel = {n: (diff2[n] / ref2[n]) ** 0.5 if ref2[n] else
               float(diff2[n] > 0) for n in got}
        rel_tol = {n: REL_TOL[o.dtype] for n, o in got.items()}
        call = {"row": row, "kernel": kernel, "shape": list(shape),
                "blocks": [cfg.block_q, cfg.block_k],
                "path": flash_path(cfg, shape[1]), "err": err, "tol": tol,
                "rel": rel, "rel_tol": rel_tol}
        self.calls.append(call)
        bad = [n for n in got if err[n] > tol[n] or rel[n] > rel_tol[n]]
        if bad:
            raise PlainMismatch(f"{row} {kernel} off its plain version: "
                                f"{call}")

    def flush(self) -> None:
        """Holds every call made since the last flush."""
        pending, self._pending = self._pending, []
        with torch.no_grad():
            for args in pending:
                self._hold(*args)

    @contextlib.contextmanager
    def active(self, row: str):
        real_fwd, real_bwd = tfa.flash_fwd, tfa.flash_bwd

        def fwd(q, k, v, cfg):
            out, lse = real_fwd(q, k, v, cfg)
            self._pending.append((
                row, "K4", cfg, q.shape, {"out": out, "lse": lse},
                lambda sl: tfa.flash_fwd_plain(q[sl], k[sl], v[sl], cfg)))
            return out, lse

        def bwd(q, k, v, out, lse, do, cfg):
            dq, dk, dv = real_bwd(q, k, v, out, lse, do, cfg)

            def plain(sl):
                delta = tfa.flash_delta_plain(out[sl], do[sl])
                return tfa.flash_bwd_plain(q[sl], k[sl], v[sl], do[sl],
                                           lse[sl], delta, cfg)

            self._pending.append((row, "K5", cfg, q.shape,
                                  {"dq": dq, "dk": dk, "dv": dv}, plain))
            return dq, dk, dv

        # the operator and its autograd look both names up at each call
        tfa.flash_fwd, tfa.flash_bwd = fwd, bwd
        try:
            yield self
        except BaseException:
            self._pending = []
            raise
        finally:
            tfa.flash_fwd, tfa.flash_bwd = real_fwd, real_bwd
        self.flush()

    def summary(self, row: str) -> Dict[str, dict]:
        """The row's largest readings and bounds per kernel output, and
        the paths its calls took."""
        out: Dict[str, dict] = {}
        for call in self.calls:
            if call["row"] != row:
                continue
            k = out.setdefault(call["kernel"], {"calls": 0, "paths": [],
                                                "err": {}, "tol": {},
                                                "rel": {}, "rel_tol": {}})
            k["calls"] += 1
            if call["path"] not in k["paths"]:
                k["paths"].append(call["path"])
            for key in ("err", "tol", "rel", "rel_tol"):
                for n, e in call[key].items():
                    k[key][n] = max(k[key].get(n, 0.0), e)
        return out


def format_check(summary: Dict[str, dict]) -> str:
    return "; ".join(
        f"{kernel} x{s['calls']} [{'/'.join(s['paths'])}] "
        + ", ".join(f"{n} err {s['err'][n]:.3g} (tol {s['tol'][n]:.3g}) "
                    f"rel {s['rel'][n]:.3g} (tol {s['rel_tol'][n]:.3g})"
                    for n in s["err"])
        for kernel, s in summary.items())


class _Clock:
    """One call's seconds: CUDA events on the current stream (the card's
    drain after the end event), or the host clock on the CPU."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        if device.type == "cuda":
            self.start, self.end = (torch.cuda.Event(enable_timing=True)
                                    for _ in range(2))
            self.start.record()
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.device.type != "cuda":
            return time.perf_counter() - self.t0
        self.end.record()
        drain(self.device)
        return self.start.elapsed_time(self.end) / 1e3


def bench(fn: Callable, make_args: Callable, device: torch.device, warm: int,
          iters: int, label: str, check: Optional[PlainCheck] = None,
          chain: bool = False, log: Callable = print) -> dict:
    """``warm`` untimed then ``iters`` timed calls, each timed between
    two CUDA events on the card's stream, recorded before and after the
    call (the host clock on the CPU): the host's dispatch inside the call
    counts where the card waits for it, the card's drain after the call
    does not. ``chain``: ``fn(state) -> state`` threaded through the
    calls (a train step's in-place state), else ``fn(*args)`` on the
    same args. Every call runs under ``check``, which holds each of its
    K4/K5 calls against the plain version after the drain, between
    calls. Returns the row: seconds per timed call, the launches over
    all its calls, the check's summary and the last call's output."""
    reset_launch_counts()
    args = make_args()
    state = args
    out = None
    total = 0.0
    with check.active(label) if check is not None else contextlib.nullcontext():
        for i in range(warm + iters):
            clock = _Clock(device)
            if chain:
                state = fn(state)
            else:
                out = fn(*args)
            seconds = clock.stop()
            if i >= warm:
                total += seconds
            if check is not None:
                check.flush()
    dt = total / iters
    row = {"row": label, "ms": dt * 1e3, "warm": warm, "iters": iters,
           "launches": {k: v for k, v in launch_counts.items() if v},
           "check": check.summary(label) if check is not None else {},
           "out": state if chain else out}
    log(f"{label:20s} {dt * 1000:9.2f} ms"
        + (f"   held: {format_check(row['check'])}" if row["check"] else ""))
    return row


def expect_launches(row: dict, device: torch.device, fwd: int,
                    bwd: int) -> None:
    """Raises unless the row launched K4 ``fwd`` and K5 ``bwd`` times a
    call, over all its calls, and nothing else (nothing on the CPU)."""
    calls = row["warm"] + row["iters"]
    want = {}
    if device.type == "cuda":
        want = {k: n * calls for k, n in (("flash_fwd", fwd),
                                          ("flash_bwd", bwd)) if n}
    if row["launches"] != want:
        raise RuntimeError(f"{row['row']}: launches {row['launches']}, "
                           f"expected {want}")

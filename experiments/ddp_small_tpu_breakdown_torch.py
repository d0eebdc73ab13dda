"""Per-phase breakdown of the link-sized per-step DDP loop on the card.
The port's counterpart of ``experiments/ddp_small_tpu_breakdown.py``: the
same setup as bench_torch's ft_ddp_small (a 2-member ring, the int8
wire, a zero peer on the host CPU) at ``bench_torch``'s ``ddp_small``
model (~0.72M params, S 2048, flash attention on the card: K4/K5 at
head_dim 64; the int8 payload: K1a/K1b to quantize, K2 to decode), run
two ways:

  A. serialized: every phase drained (``bench_torch._barrier``) so each
     timer isolates one phase: grad / quant / quorum / dispatch /
     ring_wait (split further by HostCollectives.pop_op_stats into
     pack/d2h/ring/h2d) / vote / combine / apply. The total is inflated
     by the drains; the distribution is the diagnosis.
  B. pipelined: PipelinedDDP(compress="int8") steady state, no
     intermediate drains: the rate, each step's host time, and the
     collectives' per-op stats (pack/d2h/ring/h2d) alongside.

Run alone on the card::

    python experiments/ddp_small_tpu_breakdown_torch.py

CPU rehearsal (batch 2, fewer steps; its times are the CPU's)::

    python experiments/ddp_small_tpu_breakdown_torch.py --device cpu --size tiny

Env: BENCH_DDP_SMALL_BATCH (default 256 at the flagship size, 2 tiny),
TORCHFT_HC_PIPELINE_CHUNKS (default 1, as the JAX script sets it).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import common_torch as ct  # noqa: E402
import bench_torch as bench  # noqa: E402
from torchft_tpu_torch import AdamW, FTTrainState, PipelinedDDP  # noqa: E402
from torchft_tpu_torch._tree import tree_map  # noqa: E402
from torchft_tpu_torch.models.transformer import make_grad_fn  # noqa: E402
from torchft_tpu_torch.ops import launch_counts, reset_launch_counts  # noqa: E402
from torchft_tpu_torch.quantize import (make_dequant_average,  # noqa: E402
                                        quantize_with_feedback)

# (warm-up, mode A's serialized steps, mode B's pipelined steps)
STEPS = {"flagship": (2, 6, 20), "tiny": (1, 2, 3)}
BATCH = {"flagship": "256", "tiny": "2"}
OP_KEYS = ("pack", "d2h", "ring", "h2d")


def _round(v):
    return round(v, 4) if isinstance(v, float) else v


def _median(xs):
    return round(sorted(xs)[len(xs) // 2], 4)


def run_modes(state, manager, collectives, cfg, batch, steps: tuple,
              log: Callable = print) -> dict:
    warm, fine, pipe = steps
    grad_fn = make_grad_fn(cfg)
    combine = make_dequant_average()
    residual = tree_map(lambda l: torch.zeros(l.shape, dtype=torch.float32,
                                              device=l.device), state.params)
    commits = []

    def one(rec=None):
        nonlocal residual
        t0 = time.perf_counter()
        _, grads = grad_fn(state.params, batch)
        bench._barrier(grads)
        t1 = time.perf_counter()
        out = quantize_with_feedback(grads, residual)
        residual = out["res"]
        payload = {"q": out["q"], "scale": out["scale"]}
        bench._barrier(payload["scale"])
        t2 = time.perf_counter()
        manager.start_quorum()
        manager.wait_quorum()
        t3 = time.perf_counter()
        work = manager.allgather(payload)
        t4 = time.perf_counter()
        res = work.wait()
        t5 = time.perf_counter()
        committed = manager.should_commit()
        t6 = time.perf_counter()
        avg = combine(res, float(max(manager.num_participants(), 1)))
        bench._barrier(avg)
        t7 = time.perf_counter()
        if committed:
            state.apply_gradients(avg)
        bench._barrier(state.params)
        t8 = time.perf_counter()
        commits.append(committed)
        if rec is not None:
            rec.append({"grad": t1 - t0, "quant": t2 - t1, "quorum": t3 - t2,
                        "dispatch": t4 - t3, "ring_wait": t5 - t4,
                        "vote": t6 - t5, "combine": t7 - t6,
                        "apply": t8 - t7, "total": t8 - t0})

    log("== A: serialized phases ==")
    for _ in range(warm):
        one()
    collectives.pop_op_stats()
    recs: list = []
    for i in range(fine):
        one(recs)
        log(f"  fine step {i}: {recs[-1]['total']:.3f}s")
    med = {k: _median([r[k] for r in recs]) for k in recs[0]}
    fine_ops = collectives.pop_op_stats()
    log("median s/phase: " + json.dumps(med))
    log("op stats: " + json.dumps(
        [{k: _round(v) for k, v in s.items() if k in OP_KEYS or k == "op"}
         for s in fine_ops]))

    log("== B: pipelined steady state ==")
    ddp = PipelinedDDP(manager, state, grad_fn, compress="int8",
                       transport="legacy")
    ddp.step(batch)  # warm
    bench._barrier(state.params)
    t0 = time.perf_counter()
    step_times = []
    for _ in range(pipe):
        ts = time.perf_counter()
        ddp.step(batch)
        commits.append(ddp.last_commit)
        step_times.append(time.perf_counter() - ts)
    t_end = time.perf_counter()
    commits.append(ddp.flush())
    bench._barrier(state.params)
    # the warm step's allgather may settle after the pop above: keep the
    # last ``pipe`` entries
    pipe_ops = collectives.pop_op_stats()[-pipe:]
    sps = pipe / (t_end - t0)
    agg: dict = {}
    for s in pipe_ops:
        for k in OP_KEYS:
            if k in s:
                agg.setdefault(k, []).append(s[k])
    op_med = {k: _median(v) for k, v in agg.items()}
    log(f"pipelined steps/s: {round(sps, 3)}")
    log(f"per-step host time: median {_median(step_times)} max "
        f"{round(max(step_times), 4)}")
    log("op medians: " + json.dumps(op_med))
    snap = manager.metrics().snapshot()
    log("metrics: " + json.dumps(snap, default=str))
    if collectives.size() != 2:
        raise RuntimeError("the peer did not join the ring")
    if not all(commits):
        raise RuntimeError(f"a step did not commit: {commits}")
    return {"serialized_median_s": med, "pipelined_steps_per_sec": sps,
            "pipelined_host_median_s": _median(step_times),
            "pipelined_op_median_s": op_med, "metrics": snap,
            "commits": len(commits)}


def run(device: torch.device, size: str = "flagship",
        log: Callable = print) -> dict:
    os.environ["BENCH_MODEL"] = "ddp_small"
    os.environ.setdefault("BENCH_DDP_SMALL_BATCH", BATCH[size])
    os.environ.setdefault("TORCHFT_HC_PIPELINE_CHUNKS", "1")
    cfg, batch, _ = bench._model_setup("ddp_small", device)
    log(f"device={device} batch={tuple(batch.shape)} flash={cfg.use_flash}")
    state = FTTrainState(bench._grad_params(cfg, device), AdamW(1e-3))
    reset_launch_counts()
    # bench_torch's shared lifecycle: paced peer (rounds=0), reaped on exit
    with bench._ring_session("ddp_probe", "int8", state, device=device) as (
            manager, collectives):
        res = run_modes(state, manager, collectives, cfg, batch, STEPS[size],
                        log)
    res["launches"] = {k: v for k, v in launch_counts.items() if v}
    log("launches: " + json.dumps(res["launches"]))
    res.update({"device": str(device), "size": size,
                "batch": list(batch.shape)})
    log("DONE")
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ct.add_device_args(parser)
    parser.add_argument("--json", help="also write the result here")
    args = parser.parse_args(argv)
    device = ct.resolve_device(args.device)
    card = ct.card()
    print(f"device {device}" + (f" ({card['smi']})" if card["smi"] else ""),
          flush=True)
    res = run(device, args.size, log=lambda m: print(m, flush=True))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())

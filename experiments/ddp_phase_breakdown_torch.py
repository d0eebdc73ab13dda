"""Phase-level breakdown of one per-step FT DDP step over a 2-process
ring, on the card. The port's counterpart of
``experiments/ddp_phase_breakdown.py`` (which pins the JAX CPU backend):
the same blocking loop (``OptimizerWrapper`` + ``manager.allreduce`` of
the f32 gradients), the model of ``bench_torch._model_setup()`` (the
dense cell's LM on the card: 23,337,472 params, B16 S512), and the same
zero-contributing ring peer, a process on the host CPU
(``bench_torch._spawn_peer``), so the measured process has the card
alone. Each phase is drained before the next one's clock starts:

  zero_grad   the quorum's start (async)
  grad        make_grad_fn's forward and backward
  dispatch    manager.allreduce's return
  ring_wait   the work's wait (d2h, the TCP ring, h2d)
  avg_ready   the averaged gradients on the card
  apply       the vote and the AdamW update

Prints each phase's median ms over the timed steps and the manager's
metrics.

Run alone on the card::

    python experiments/ddp_phase_breakdown_torch.py

CPU rehearsal (bench's CPU branch, fewer steps; its times are the CPU's)::

    python experiments/ddp_phase_breakdown_torch.py --device cpu --size tiny
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from datetime import timedelta
from typing import Callable

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import common_torch as ct  # noqa: E402
import bench_torch as bench  # noqa: E402
from torchft_tpu_torch import (AdamW, FTTrainState, HostCollectives,  # noqa: E402
                               Lighthouse, Manager, OptimizerWrapper)
from torchft_tpu_torch.models.transformer import make_grad_fn  # noqa: E402

# (warm-up steps, timed steps)
STEPS = {"flagship": (2, 8), "tiny": (1, 2)}


def run(device: torch.device, size: str = "flagship",
        log: Callable = print) -> dict:
    warm, steps = STEPS[size]
    cfg, batch, _ = bench._model_setup(device=device)
    os.environ["BENCH_FORCE_LAYERS"] = str(cfg.n_layers)
    grad_fn = make_grad_fn(cfg)
    lighthouse = Lighthouse(bind="[::]:0", min_replicas=1,
                            join_timeout_ms=5000, quorum_tick_ms=50)
    peer = manager = collectives = None
    try:
        peer = bench._spawn_peer(lighthouse.address(), warm + steps, "f32")
        state = FTTrainState(bench._grad_params(cfg, device), AdamW(1e-3))
        collectives = HostCollectives(timeout=timedelta(seconds=600))
        manager = Manager(
            collectives=collectives, load_state_dict=state.load_state_dict,
            state_dict=state.state_dict, min_replica_size=1,
            timeout=timedelta(seconds=300),
            quorum_timeout=timedelta(seconds=300), rank=0, world_size=1,
            lighthouse_addr=lighthouse.address(),
            replica_id="bench_main_probe", device=device)
        optimizer = OptimizerWrapper(manager, state)

        def one(record=None):
            t0 = time.perf_counter()
            optimizer.zero_grad()
            t1 = time.perf_counter()
            _, grads = grad_fn(state.params, batch)
            bench._barrier(grads)
            t2 = time.perf_counter()
            work = manager.allreduce(grads)
            t3 = time.perf_counter()
            avg = work.wait()
            t4 = time.perf_counter()
            bench._barrier(avg)
            t5 = time.perf_counter()
            committed = optimizer.step(avg)
            bench._barrier(state.params)
            t6 = time.perf_counter()
            if not committed:
                raise RuntimeError("a step did not commit")
            if record is not None:
                record.append({"zero_grad": t1 - t0, "grad": t2 - t1,
                               "dispatch": t3 - t2, "ring_wait": t4 - t3,
                               "avg_ready": t5 - t4, "apply": t6 - t5,
                               "total": t6 - t0})

        for _ in range(warm):
            one()
        recs: list = []
        for _ in range(steps):
            one(recs)
        med = {k: round(sorted(r[k] for r in recs)[len(recs) // 2] * 1000, 3)
               for k in recs[0]}
        log("median ms per phase: " + json.dumps(med))
        snap = manager.metrics().snapshot()
        log("metrics: " + json.dumps(snap, default=str))
        if collectives.size() != 2:
            raise RuntimeError("the peer did not join the ring")
        peer.wait(timeout=120)
        return {"device": str(device), "size": size, "batch": list(batch.shape),
                "steps": steps, "median_ms": med, "metrics": snap,
                "ring_size": collectives.size()}
    finally:
        if peer is not None:
            bench._reap_peer(peer)
        if manager is not None:
            manager.shutdown()
        if collectives is not None:
            collectives.shutdown()
        lighthouse.shutdown()


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

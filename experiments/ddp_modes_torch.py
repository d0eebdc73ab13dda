"""Per-step FT DDP on the card: the raw loop against blocking, pipelined
and pipelined-bf16 DDP over a 2-process ring. The port's counterpart of
``experiments/ddp_modes.py`` (which pins the JAX CPU backend): the same
four loops at the model of ``bench_torch._model_setup()`` (the dense
cell's LM on the card), each DDP mode against a fresh lighthouse and its
own zero-contributing peer on the host CPU (``bench_torch._spawn_peer``):

  raw             make_grad_fn + the AdamW update, no FT machinery
  blocking        OptimizerWrapper + manager.allreduce (f32 wire)
  pipelined       PipelinedDDP (legacy transport, f32 wire): step i's
                  ring pass behind step i+1's forward and backward
  pipelined_bf16  the same on the bf16 wire (K3 casts the gradients)

Each mode's rate is over its timed steps after the warm-up, the final
settle (flush) inside the clock; the ratio is against raw.

Run alone on the card::

    python experiments/ddp_modes_torch.py

CPU rehearsal (bench's CPU branch, fewer steps; its times are the CPU's)::

    python experiments/ddp_modes_torch.py --device cpu --size tiny
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
                               Lighthouse, Manager, OptimizerWrapper,
                               PipelinedDDP)
from torchft_tpu_torch.models.transformer import make_grad_fn, param_count  # noqa: E402
from torchft_tpu_torch.ops import launch_counts, reset_launch_counts  # noqa: E402

MODES = ("blocking", "pipelined", "pipelined_bf16")
# (raw warm-up steps, raw timed steps, a mode's warm-up, a mode's timed)
STEPS = {"flagship": (3, 10, 2, 10), "tiny": (1, 2, 2, 2)}


def run_mode(mode: str, cfg, batch, grad_fn, device: torch.device,
             warm: int, steps: int) -> dict:
    """One DDP mode's timed steps over a fresh 2-member ring."""
    # a fresh lighthouse per mode: back-to-back modes on one would show
    # the previous mode's members as ghosts
    lighthouse = Lighthouse(bind="[::]:0", min_replicas=1,
                            join_timeout_ms=5000, quorum_tick_ms=50)
    wire = "bf16" if mode == "pipelined_bf16" else "f32"
    peer = manager = collectives = None
    commits = []
    try:
        peer = bench._spawn_peer(lighthouse.address(), warm + steps, wire)
        state = FTTrainState(bench._grad_params(cfg, device), AdamW(1e-3))
        collectives = HostCollectives(timeout=timedelta(seconds=600))
        manager = Manager(
            collectives=collectives, load_state_dict=state.load_state_dict,
            state_dict=state.state_dict, min_replica_size=1,
            timeout=timedelta(seconds=300),
            quorum_timeout=timedelta(seconds=300), rank=0, world_size=1,
            lighthouse_addr=lighthouse.address(),
            # sorts before "bench_peer": the step-0 primary is the first
            # replica id, and the peer never serves a checkpoint
            replica_id=f"bench_main_{mode}", device=device)
        reset_launch_counts()
        if mode == "blocking":
            optimizer = OptimizerWrapper(manager, state)

            def one():
                optimizer.zero_grad()
                _, grads = grad_fn(state.params, batch)
                avg = manager.allreduce(grads).wait()
                commits.append(optimizer.step(avg))

            for _ in range(warm):
                one()
            bench._barrier(state.params)
            t0 = time.perf_counter()
            for _ in range(steps):
                one()
            bench._barrier(state.params)
            dt = time.perf_counter() - t0
        else:
            ddp = PipelinedDDP(
                manager, state, grad_fn, transport="legacy",
                compress="bf16" if mode == "pipelined_bf16" else None)

            def one():
                ddp.step(batch)
                if ddp.last_commit is not None:
                    commits.append(ddp.last_commit)
                    ddp.last_commit = None

            for _ in range(warm):
                one()
            # warm boundary: the timed region starts with the warm-up's
            # last step in flight, and its final settle is inside it
            bench._barrier(state.params)
            t0 = time.perf_counter()
            for _ in range(steps):
                one()
            commits.append(ddp.flush())
            bench._barrier(state.params)
            dt = time.perf_counter() - t0
        snap = manager.metrics().snapshot()
        if collectives.size() != 2:
            raise RuntimeError("the peer did not join the ring")
        if not all(commits):
            raise RuntimeError(f"{mode}: a step did not commit: {commits}")
        peer.wait(timeout=120)
        keep = {k: v for k, v in snap["timers_s"].items()
                if any(s in k for s in ("quorum", "allreduce", "commit",
                                        "reconf"))}
        return {"steps_per_sec": steps / dt, "steps": steps,
                "commits": len(commits), "timers_s": keep,
                "launches": {k: v for k, v in launch_counts.items() if v}}
    finally:
        if peer is not None:
            bench._reap_peer(peer)
        if manager is not None:
            manager.shutdown()
        if collectives is not None:
            collectives.shutdown()
        lighthouse.shutdown()


def run(device: torch.device, size: str = "flagship",
        log: Callable = print) -> dict:
    raw_warm, raw_steps, warm, steps = STEPS[size]
    cfg, batch, _ = bench._model_setup(device=device)
    os.environ["BENCH_FORCE_LAYERS"] = str(cfg.n_layers)
    grad_fn = make_grad_fn(cfg)
    tx = AdamW(1e-3)
    params = bench._grad_params(cfg, device)
    n_params = param_count(params)
    log(f"n_params={n_params / 1e6:.1f}M  ({n_params * 4 / 1e6:.0f} MB f32)")
    opt_state = tx.init(params)

    def raw_step():
        _, grads = grad_fn(params, batch)
        tx.update_(params, opt_state, grads)

    for _ in range(raw_warm):
        raw_step()
    bench._barrier(params)
    t0 = time.perf_counter()
    for _ in range(raw_steps):
        raw_step()
    bench._barrier(params)
    raw_sps = raw_steps / (time.perf_counter() - t0)
    log(f"raw: {raw_sps:.3f} steps/s ({1 / raw_sps * 1000:.1f} ms/step)")
    del params, opt_state
    out = {"device": str(device), "size": size, "batch": list(batch.shape),
           "n_params": n_params, "raw_steps_per_sec": raw_sps, "modes": {}}
    for mode in MODES:
        res = run_mode(mode, cfg, batch, grad_fn, device, warm, steps)
        res["ratio_vs_raw"] = res["steps_per_sec"] / raw_sps
        out["modes"][mode] = res
        log(f"{mode}: {res['steps_per_sec']:.3f} steps/s (ratio "
            f"{res['ratio_vs_raw']:.3f}); launches "
            f"{json.dumps(res['launches'])}")
        log("   timers: " + json.dumps(res["timers_s"], default=str)[:600])
    log("done")
    return out


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

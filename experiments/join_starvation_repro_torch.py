"""Repro: two groups form a cohort; a third joins 2 s late. How long until
it takes part in a quorum of three? The port's counterpart of
``experiments/join_starvation_repro.py``: three replica groups as
threads of one process, each a ``Manager`` over ``HostCollectives``
with an ``OptimizerWrapper`` over an ``FTTrainState`` (SGD 0.1), against
one in-process ``Lighthouse`` (join timeout 200 ms, tick 50 ms,
heartbeat timeout 500 ms), ~20 steps/s each. Prints each group's
``first_3party_s`` (seconds from its Manager to its first step in a
quorum of three; None if never), ``commits_in_3party`` (its committed
steps in such a quorum) and ``final_step``.

The tensors live on the card unless ``--device cpu``; without a card and
without it the script raises::

    python experiments/join_starvation_repro_torch.py [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from datetime import timedelta

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from torchft_tpu_torch import (  # noqa: E402
    SGD,
    FTTrainState,
    HostCollectives,
    Lighthouse,
    Manager,
    OptimizerWrapper,
)
from torchft_tpu_torch._device import resolve_device  # noqa: E402

# how long the run waits for each group's thread to finish
JOIN_TIMEOUT_S = 120.0

def worker(lighthouse: Lighthouse, device: torch.device, gid: int,
           delay: float, steps: int, out: dict) -> None:
    time.sleep(delay)
    state = FTTrainState({"w": torch.ones(4, device=device)}, SGD(0.1))
    collectives = HostCollectives(timeout=timedelta(seconds=30))
    manager = Manager(
        collectives=collectives,
        load_state_dict=state.load_state_dict,
        state_dict=state.state_dict,
        min_replica_size=1,
        heartbeat_interval=timedelta(milliseconds=50),
        replica_id=f"join_{gid}",
        lighthouse_addr=lighthouse.address(),
        device=device,
    )
    optimizer = OptimizerWrapper(manager, state)
    t_mgr = time.time()
    first_multi = None
    commits_multi = 0
    grads = {"w": torch.ones(4, device=device)}
    try:
        while manager.current_step() < steps:
            optimizer.zero_grad()
            avg = manager.allreduce(grads).wait()
            committed = optimizer.step(avg)
            n = manager.num_participants()
            if n >= 3 and first_multi is None:
                first_multi = time.time() - t_mgr
            commits_multi += int(n >= 3 and committed)
            time.sleep(0.05)  # ~20 steps/s pace
        out[gid] = {"first_3party_s": first_multi,
                    "commits_in_3party": commits_multi,
                    "final_step": manager.current_step()}
    finally:
        manager.shutdown()
        collectives.shutdown()


def run(device: torch.device, steps: int = 200, delay: float = 2.0) -> dict:
    """The three groups (the third ``delay`` s late); returns the seconds
    the run took and each finished group's record."""
    lighthouse = Lighthouse(bind="[::]:0", min_replicas=1,
                            join_timeout_ms=200, quorum_tick_ms=50,
                            heartbeat_timeout_ms=500)
    out: dict = {}
    ts = [threading.Thread(target=worker,
                           args=(lighthouse, device, g, d, steps, out))
          for g, d in ((0, 0.0), (1, 0.0), (2, delay))]
    t0 = time.time()
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=JOIN_TIMEOUT_S)
    finally:
        lighthouse.shutdown()
    return {"elapsed_s": round(time.time() - t0, 1),
            "groups": {str(g): out[g] for g in sorted(out)}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="cpu for the CPU (default: the card; raises "
                        "without one)")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--delay", type=float, default=2.0,
                        help="seconds the third group starts late")
    args = parser.parse_args(argv)
    res = run(resolve_device(args.device), args.steps, args.delay)
    print("elapsed", res["elapsed_s"], json.dumps(res["groups"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

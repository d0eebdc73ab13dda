"""Runs a trainer script of the port as a user would (``python SCRIPT``,
through ``runpy``) and records what a checker needs and the script does
not print::

    python scripts/train_record_torch.py OUTDIR SCRIPT

Into OUTDIR, named by this process's pid:

- ``start_<pid>.json`` at the start and ``end_<pid>.json`` at the exit
  (a failed run too): the replica group, whether the process is a hot
  spare, the model; at the end the port's kernel launch counts, the
  manager's step, batches committed, counters, last heal and the p50 of
  each of its timers, each commit's step and wall time, the wall times
  of the start and of the Manager's creation (a hot spare's also of its
  arrival at the standby gate and of its promotion, the mtimes of the
  gate's files), the optimizer's learning
  rate, and the final params (``params_<pid>.pt`` and their sha256).
- ``served_<pid>_<step>.pt``: each state the process hands a healing
  peer, as the manager asks for it, and ``healed_<pid>_<step>.pt``: the
  state a heal left, as the first commit vote after it sees it (before
  the optimizer's update). Both hold the state's tensor leaves in the
  heal staging's order, their paths, and which of them a bf16 heal wire
  narrows (the f32 ``opt_state`` leaves).

The script is not changed. ``Manager.__init__`` and
``FTTrainState.__init__`` are wrapped in place on their classes, so
whatever name the script imports them by: the first registers a commit
hook (``Manager.add_commit_hook``) and wraps the ``state_dict`` callback
the script passes; the second keeps the state for its learning rate and
final params. The rest is read through the manager's own accessors
(``metrics().snapshot()``, ``checkpoint_transport().last_fetch_stats``).
"""

import hashlib
import json
import os
import runpy
import sys
import time

t_start = time.time()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from torchft_tpu_torch import ops  # noqa: E402
from torchft_tpu_torch._tree import flatten, flatten_with_path, is_opt_state_path  # noqa: E402
from torchft_tpu_torch.manager import Manager  # noqa: E402
from torchft_tpu_torch.train_state import FTTrainState  # noqa: E402


def _tensors(tree) -> dict:
    """A state tree's tensor leaves as host copies, in the heal staging's
    order, with their paths and the bf16 wire's narrowing flags."""
    ents = [(p, l) for p, l in flatten_with_path(tree)[0]
            if isinstance(l, torch.Tensor)]
    return {"leaves": [l.detach().cpu().clone() for _, l in ents],
            "paths": ["/".join(map(str, p)) for p, _ in ents],
            "narrow": [l.dtype == torch.float32 and is_opt_state_path(p)
                       for p, l in ents]}


def main(out: str, script: str) -> None:
    pid = os.getpid()
    rec = {"pid": pid, "group": int(os.environ.get("REPLICA_GROUP_ID", "0")),
           "standby": bool(os.environ.get("TORCHFT_STANDBY_FILE")),
           "model": os.environ.get("MODEL", "mlp"), "t_start": t_start,
           "commits": []}
    states, managers = [], []

    def write(kind: str) -> None:
        path = os.path.join(out, f"{kind}_{pid}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(rec, f, default=str)
        os.replace(path + ".tmp", path)  # readers never see half a record

    def save(kind: str, step: int, tree) -> None:
        path = os.path.join(out, f"{kind}_{pid}_{step}.pt")
        torch.save({"step": step, **_tensors(tree)}, path + ".tmp")
        os.replace(path + ".tmp", path)

    manager_init, state_init = Manager.__init__, FTTrainState.__init__

    def init_manager(self, *a, **k):
        rec["t_manager"] = time.time()
        gate = os.environ.get("TORCHFT_STANDBY_FILE")
        if gate:  # a spare: when it reached the gate, when it was let go
            rec["t_gate"] = os.path.getmtime(gate + ".warm")
            rec["t_promoted"] = os.path.getmtime(gate)
        user_state_dict = k.get("state_dict")
        if user_state_dict is not None:
            def served():
                sd = user_state_dict()
                save("served", self.current_step(), sd)
                return sd

            k["state_dict"] = served
        manager_init(self, *a, **k)
        managers.append(self)
        seen = {"fetch": None}

        def on_commit(step, qid, ok):
            if ok:
                rec["commits"].append([step, time.time()])
            fetch = self.checkpoint_transport().last_fetch_stats
            if user_state_dict is not None and fetch is not None \
                    and fetch is not seen["fetch"]:
                seen["fetch"] = fetch
                save("healed", step - int(ok), user_state_dict())

        self.add_commit_hook(on_commit)

    def init_state(self, *a, **k):
        state_init(self, *a, **k)
        states.append(self)

    Manager.__init__, FTTrainState.__init__ = init_manager, init_state
    ops.reset_launch_counts()
    write("start")
    sys.argv = [script]
    try:
        runpy.run_path(script, run_name="__main__")
        rec["rc"] = 0
    except BaseException as e:
        rec["error"] = repr(e)
        raise
    finally:
        rec["t_end"] = time.time()
        rec["launches"] = dict(ops.launch_counts)
        if managers:
            m = managers[-1]
            rec["step"] = m.current_step()
            rec["batches_committed"] = m.batches_committed()
            rec["heal"] = m.checkpoint_transport().last_fetch_stats
            snap = m.metrics().snapshot()
            rec["counters"] = snap["counters"]
            rec["timers_p50_ms"] = {k: round(1e3 * t["p50"], 3)
                                    for k, t in snap["timers_s"].items()
                                    if t["n"]}
        if states:
            rec["lr"] = states[-1].tx.lr
            leaves = [l.detach().cpu() for l in flatten(states[-1].params)[0]]
            h = hashlib.sha256()
            for l in leaves:
                h.update(l.contiguous().view(torch.uint8).numpy().tobytes())
            rec["digest"] = h.hexdigest()
            rec["params"] = os.path.join(out, f"params_{pid}.pt")
            torch.save(leaves, rec["params"])
        write("end")


if __name__ == "__main__":
    main(*sys.argv[1:3])

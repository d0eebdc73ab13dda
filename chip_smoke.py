#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (torchft_tpu_torch) on one GPU.

Drives the port's two main paths — the per-step fault-tolerant training
transaction on the dense LM, and on the flash-attention LM — through the
entry points a user calls, at full width (random weights from a seed):
the transformer LM the repository benchmarks by default (vocab 8192,
d_model 512, 8 heads, 6 layers, d_ff 2048, sequence 512, batch 16: 39 f32
leaves, 23,337,472 parameters, dense attention), and bench.py's "big" LM
(vocab 8192, d_model 1024, 16 heads of 64, 8 layers, d_ff 4096, sequence
2048, batch 16: 51 f32 leaves, 111,166,464 parameters, use_flash=True):

1. build   the native control plane and the CUDA kernels from the sources
           in the checkout (in parallel, one nvcc per source); prints each
           kernel's registers and spills from ptxas (-Xptxas -v) and the
           dynamic shared memory a launch of it takes;
2. kernels every wire kernel (K1a q8 absmax, K1b q8 quantize, K2 q8
           decode, K3 bf16 cast) against its plain PyTorch version on the
           card, bit for bit, at the dense path's 39 leaf shapes and
           special cases (ragged, all-zero, NaN, Inf, NaN bit patterns);
           times each kernel, its plain version and the PyTorch library
           call where one exists;
3. flash   the flash-attention kernels (K4 forward, K5 backward: bf16 on
           the tensor-core kernels, f32 on the scalar ones) against their
           plain versions on the card within printed tolerances: the big
           LM's call (16, 2047, 16, 64) bf16 causal, S 2048, non-causal,
           windows 1/16/200/1000, block_k 32 (the general path), head_dim
           128 and f32 inputs; K5 run twice must give the same bits; times
           both (and K5's two kernels) at the big LM's call beside their
           bounds and achieved TFLOP/s, their plain versions and
           scaled_dot_product_attention's (timed only, never used by the
           port);
4. train   an in-process lighthouse and two replica-group worker processes
           sharing the GPU, each running Manager + HostCollectives +
           FTTrainState/AdamW + PipelinedDDP(compress="q8",
           transport="plan", device_pack=True), which gates every update
           on the commit vote: 2 warm-up steps (first quorum, ring, plan,
           staging), 6 timed steps, 3 steps under a torch.profiler trace
           of the card (group 0), then one step with compress="bf16";
5. heal    a third worker joins late, heals from a live peer through the
           CheckpointServer onto the card, and all three train on;
6. flash train  two replica-group workers train the big LM with
           use_flash=True through the same PipelinedDDP(compress="q8")
           transaction: 2 warm-up steps, 4 timed steps, then 2 steps under
           a torch.profiler trace of the card (group 0), which must show
           the tensor-core flash kernels; group 0 first holds the flash
           loss against the dense loss on the same weights (forward only,
           batch 2).

Checks: every step commits; every loss is finite; each worker's kernel
launch counts equal leaves x q8 steps (K1a, K1b), groups x bf16 steps
(K3), layers x forward/backward passes (K4) and 2 x layers x passes (K5;
a pass per step, and one more for a step whose gradients a heal made
stale), and 0 for every other kernel — the counts are reset to 0 in each worker just before it
drives a path and read just after; all groups end bit-identical, the
healed one included. Prints one ``kernels`` JSON line, the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``. Any
failed phase exits non-zero.

Usage: ``python3 chip_smoke.py`` (needs one CUDA device; the workers are
this script re-run with ``--worker``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
LM = dict(vocab_size=8192, d_model=512, n_heads=8, n_layers=6, d_ff=2048,
          max_seq_len=512)
BATCH, SEQ = 16, 512
WARM_STEPS = 2         # untimed q8 steps: first quorum, ring, plan, staging
Q8_STEPS = 6           # timed PipelinedDDP(q8) steps of the train phase
TRACED_STEPS = 3       # q8 steps under the profiler (not timed)
TRACED_FLASH_STEPS = 2  # flash steps under the profiler (not timed)
HEAL_STEPS = 3         # steps all three groups take after the late join
# bench.py's "big" LM (bench.py:131-147) on its flash path
BIG_LM = dict(vocab_size=8192, d_model=1024, n_heads=16, n_layers=8,
              d_ff=4096, max_seq_len=2048, use_flash=True)
BIG_BATCH, BIG_SEQ = 16, 2048
FLASH_STEPS = 4        # timed flash steps, after WARM_STEPS untimed ones
# the big LM's attention call: (B, S, H, head_dim), S = 2048 less the
# token loss_fn drops
FLASH_SHAPE = (BIG_BATCH, BIG_SEQ - 1, 16, 64)
# flash vs dense loss on the same weights, bf16 compute: two bf16 steps
# (2**-7) relative. The paths round attention probabilities to bf16 at
# different points (dense: normalised, flash: against each tile's
# running max), a fraction of a bf16 step per output element.
FLASH_DENSE_LOSS_RTOL = 2.0 ** -7
# H100 SXM (NVIDIA data sheet): HBM3 rate, dense bf16 tensor-core and
# f32 (non-tensor) peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
KERNEL_SOURCES = {
    "q8_absmax": "torchft_tpu_torch/csrc/quantize_kernels.cu",
    "q8_quantize": "torchft_tpu_torch/csrc/quantize_kernels.cu",
    "q8_dequantize": "torchft_tpu_torch/csrc/quantize_kernels.cu",
    "cast_bf16": "torchft_tpu_torch/csrc/quantize_kernels.cu",
    "flash_fwd": "torchft_tpu_torch/csrc/flash_attention.cu",
    "flash_bwd": "torchft_tpu_torch/csrc/flash_attention.cu",
}
PACK_KERNELS = ("absmax_kernel", "quantize_kernel", "cast_bf16_kernel")
# the flash kernels' names in a trace (both families), and the tensor-core
# kernels the bf16 path runs
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
MMA_KERNELS = ("flash_fwd_mma_kernel", "flash_bwd_dkdv_mma_kernel",
               "flash_bwd_dq_mma_kernel")
TRACE_FILE = "trace_g0.json"
REPLACES = {
    "q8_absmax": "torchft_tpu/ops/quantize_kernels.py:109",
    "q8_quantize": "torchft_tpu/ops/quantize_kernels.py:175",
    "q8_dequantize": "torchft_tpu/ops/quantize_kernels.py:253",
    "cast_bf16": "torchft_tpu/ops/quantize_kernels.py:281",
    "flash_fwd": "torchft_tpu/ops/flash_attention.py:261",
    "flash_bwd": "torchft_tpu/ops/flash_attention.py:382",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# -- worker: one replica group --------------------------------------------------


def _tokens(cfg: dict, step: int, device: torch.device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(1000 * cfg["group"] + step)
    return torch.randint(0, cfg["lm"]["vocab_size"], (cfg["batch"], cfg["seq"]),
                         generator=gen).to(device)


def _digest(params) -> str:
    from torchft_tpu_torch._tree import flatten

    h = hashlib.sha256()
    for p in flatten(params)[0]:
        h.update(p.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _timer_means_ms(before: dict, after: dict) -> dict:
    """Mean ms of each transaction timer (quorum, plan_allreduce from
    dispatch to result, commit_vote, reconfigure, heal_fetch) over the
    samples taken between two snapshots, with the largest seen so far."""
    means = {}
    for name, a in after.items():
        b = before.get(name, {"n": 0, "total_s": 0.0})
        n = a["n"] - b["n"]
        if n > 0:
            means[name] = {"n": n, "mean": round(
                1e3 * (a["total_s"] - b.get("total_s", 0.0)) / n, 3),
                "max_so_far": round(1e3 * a["max"], 3)}
    return means


def _intervals_ms(events) -> list:
    return sorted((e["ts"] / 1e3, (e["ts"] + e["dur"]) / 1e3) for e in events)


def _union_ms(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _trace_summary(path: str) -> dict:
    """Where the ring ran against the card's work, from a torch.profiler
    chrome trace of PipelinedDDP steps. On the card's clock each step's
    ring window opens when the packer stream's last device-to-host copy
    of that step ends (the native ring starts on the staged bytes) and
    closes when the first host-to-device upload of its result starts.
    Reports, per step, the window and how much of the loop stream's
    kernel time (the next step's forward/backward) ran inside it; the
    loop stream's and the packer stream's kernel time over the trace; and
    the card's busy share (this process's work) over the traced span."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                  "gpu_memset") and "dur" in e]
    if not dev:
        return {"device_events": 0}
    stream = lambda e: e.get("args", {}).get("stream")
    pack_streams = {stream(e) for e in dev
                    if e["cat"] == "kernel"
                    and any(k in e["name"] for k in PACK_KERNELS)}
    d2h = _intervals_ms(e for e in dev if e["cat"] == "gpu_memcpy"
                        and stream(e) in pack_streams and "DtoH" in e["name"])
    # the result's uploads come from pinned staging, the tokens' do not
    h2d = _intervals_ms(e for e in dev if e["cat"] == "gpu_memcpy"
                        and stream(e) not in pack_streams
                        and "HtoD" in e["name"] and "Pageable" not in e["name"])
    loop_kernels = _intervals_ms(e for e in dev if e["cat"] == "kernel"
                                 and stream(e) not in pack_streams)
    pack_kernels = _intervals_ms(e for e in dev if e["cat"] == "kernel"
                                 and stream(e) in pack_streams)
    windows = []
    for i, (_, d2h_end) in enumerate(d2h):
        if i + 1 < len(d2h) and d2h[i + 1][0] - d2h_end < 1.0:
            continue  # the payload and scale copies of one step: take the last
        starts = [a for a, _ in h2d if a > d2h_end]
        if starts:
            windows.append((d2h_end, starts[0]))
    inside = [sum(max(0.0, min(b, w1) - max(a, w0)) for a, b in loop_kernels)
              for w0, w1 in windows]
    span = (min(a for a, _ in _intervals_ms(dev)),
            max(b for _, b in _intervals_ms(dev)))
    return {
        "device_events": len(dev),
        "pack_streams": sorted(map(str, pack_streams)),
        "ring_windows_ms": [round(w1 - w0, 3) for w0, w1 in windows],
        "loop_kernel_ms_inside_ring": [round(x, 3) for x in inside],
        "loop_kernel_ms_total": round(sum(b - a for a, b in loop_kernels), 3),
        "pack_kernel_ms_total": round(sum(b - a for a, b in pack_kernels), 3),
        "traced_ms": round(span[1] - span[0], 3),
        "card_busy_share": round(_union_ms(_intervals_ms(dev))
                                 / (span[1] - span[0]), 4),
        "flash_kernel_ms_total": round(sum(
            e["dur"] for e in dev if e["cat"] == "kernel"
            and any(k in e["name"] for k in FLASH_KERNELS)) / 1e3, 3),
        "flash_kernels": _top_kernels(
            [e for e in dev if any(k in e["name"] for k in FLASH_KERNELS)]),
        "top_kernels": _top_kernels(dev),
    }


def _top_kernels(dev, top: int = 6) -> list:
    """The kernels that took the most device time in the trace, by name."""
    by_name: dict = {}
    for e in dev:
        if e["cat"] == "kernel":
            n, ms = by_name.get(e["name"], (0, 0.0))
            by_name[e["name"]] = (n + 1, ms + e["dur"] / 1e3)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return [{"name": name[:90], "n": n, "ms": round(ms, 3)}
            for name, (n, ms) in ranked]


def _wait_for(path: str, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"gate {path} never opened")
        time.sleep(0.05)


def _flash_vs_dense(model_cfg, params, cfg: dict, device: torch.device) -> dict:
    """The flash path's loss and the dense path's on the same weights and
    tokens, forward only, at batch 2 (the dense path's f32 (S, S) scores
    are then 0.5 GB a layer)."""
    import dataclasses

    from torchft_tpu_torch.models import transformer as tt

    tokens = _tokens({**cfg, "batch": 2}, 10**6 + 1, device)
    dense_cfg = dataclasses.replace(model_cfg, use_flash=False)
    with torch.no_grad():
        return {"flash": float(tt.loss_fn(model_cfg, params, tokens)),
                "dense": float(tt.loss_fn(dense_cfg, params, tokens))}


def worker(cfg: dict) -> None:
    import torchft_tpu_torch as tft
    from torchft_tpu_torch.models import transformer as tt
    from torchft_tpu_torch.ops import quantize_kernels as qk

    g, workdir = cfg["group"], cfg["workdir"]
    device = torch.device(cfg["device"])
    on_card = device.type == "cuda"
    model_cfg = tt.TransformerConfig(**cfg["lm"])
    model = tt.TransformerLM(model_cfg, seed=0, device=device)
    state = tft.FTTrainState(model.params(), tft.AdamW(1e-3, weight_decay=1e-4))
    model_grad_fn = tt.make_grad_fn(model_cfg)
    grad_calls = [0]  # forward/backward passes: steps plus heal recomputes

    def grad_fn(params, tokens):
        grad_calls[0] += 1
        return model_grad_fn(params, tokens)

    out = {"group": g, "phases": {}}
    if cfg["role"] == "flash" and g == 0:
        out["flash_vs_dense"] = _flash_vs_dense(model_cfg, state.params, cfg,
                                                device)
    # Warm up before joining (library init, allocator), and time the
    # forward/backward alone: a step's compute, against which the
    # transaction's overhead is read. Both founders run this at once, so
    # it sees the same sharing of the card as their steps.
    warm = _tokens(cfg, 10**6, device)
    compute_s = []
    for _ in range(4):
        t0 = time.perf_counter()
        grad_fn(state.params, warm)
        if on_card:
            torch.cuda.synchronize()
        compute_s.append(time.perf_counter() - t0)
    collectives = tft.HostCollectives()
    manager = tft.Manager(
        collectives=collectives, load_state_dict=state.load_state_dict,
        state_dict=state.state_dict, min_replica_size=2, rank=0,
        world_size=1, lighthouse_addr=cfg["lighthouse"], replica_id=f"g{g}",
    )
    out["compute_s"] = sorted(compute_s[1:])[1]
    n_layers = len(state.params["blocks"])
    n_leaves = n_layers * 6 + 3

    def run(phase: str, compress: str, more, trace: bool = False) -> None:
        """PipelinedDDP steps while ``more(i, committed_step)``, then a
        flush that settles the last one. A step's time ends when the
        loop's own stream has drained (not the whole card: the packer's
        stream and the ring may still run, as in training)."""
        ddp = tft.PipelinedDDP(manager, state, grad_fn, compress=compress,
                               transport="plan", device_pack=True)
        prof = None
        if trace and on_card:  # the card's activity only: little host cost
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        before = manager.metrics().snapshot()
        calls_before = grad_calls[0]
        qk.reset_launch_counts()
        losses, commits, dispatches, step_s = [], [], 0, []
        t_start = t_prev = time.perf_counter()
        i = 0
        while more(i, manager.current_step()):
            losses.append(ddp.step(_tokens(cfg, cfg["data_offset"] + i, device)))
            i += 1
            dispatches += 1
            if ddp.last_commit is not None and dispatches > 1:
                commits.append(ddp.last_commit)
            if on_card:
                torch.cuda.current_stream().synchronize()
            now = time.perf_counter()
            step_s.append(now - t_prev)
            t_prev = now
        commits.append(ddp.flush())
        if on_card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t_start
        launches = dict(qk.launch_counts)
        grad_passes = grad_calls[0] - calls_before
        if prof:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(workdir, TRACE_FILE))
            out["trace"] = _trace_summary(os.path.join(workdir, TRACE_FILE))
        cfg["data_offset"] += i
        out["phases"][phase] = {
            "dispatches": dispatches,
            "commits": commits,
            "losses": [float(l) for l in losses],
            "launches": launches,
            "grad_passes": grad_passes,
            "step_s": step_s,
            "window_s": window_s,
            "timers_ms": _timer_means_ms(
                before["timers_s"], manager.metrics().snapshot()["timers_s"]),
            "heals": {k: v - before["counters"].get(k, 0) for k, v in
                      manager.metrics().snapshot()["counters"].items()
                      if "heals" in k},
            "step": manager.current_step(),
            "digest": _digest(state.params),
        }

    joined: dict = {}

    def until_healed_and_on(i: int, step: int) -> bool:
        """Train until HEAL_STEPS steps after the first three-member quorum.
        Its step is the same on every member: the founders' committed step
        when it formed, the max_step the late group healed to."""
        if "at" not in joined and collectives.size() == 3:
            joined["at"] = step
        return "at" not in joined or step < joined["at"] + HEAL_STEPS

    try:
        if cfg["role"] == "late":
            # heartbeating from construction: the next quorum waits for us
            open(os.path.join(workdir, "late_up"), "w").close()
            run("heal", "q8", until_healed_and_on)
            out["heals"] = manager.metrics().snapshot()["counters"].get("heals", 0)
            out["fetch"] = manager.checkpoint_transport().last_fetch_stats
        elif cfg["role"] == "flash":
            run("warm", "q8", lambda i, step: i < WARM_STEPS)
            run("flash", "q8", lambda i, step: i < FLASH_STEPS)
            run("traced", "q8", lambda i, step: i < TRACED_FLASH_STEPS,
                trace=g == 0)
        else:
            run("warm", "q8", lambda i, step: i < WARM_STEPS)
            run("q8", "q8", lambda i, step: i < Q8_STEPS)
            run("traced", "q8", lambda i, step: i < TRACED_STEPS,
                trace=g == 0)
            run("bf16", "bf16", lambda i, step: i < 1)
            open(os.path.join(workdir, f"ready_{g}"), "w").close()
            _wait_for(os.path.join(workdir, "late_up"), 300)
            run("heal", "q8", until_healed_and_on)
        out["n_leaves"], out["n_layers"] = n_leaves, n_layers
        if on_card:
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    finally:
        manager.shutdown()
        collectives.shutdown()
    with open(os.path.join(workdir, f"result_{g}.json"), "w") as f:
        json.dump(out, f)


# -- parent phases ---------------------------------------------------------------


def phase_build() -> dict:
    from torchft_tpu_torch import _build

    t0 = time.perf_counter()
    errors = []
    times = {}

    def run(name, fn):
        t = time.perf_counter()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - reported below, then fatal
            errors.append(f"{name}: {e}")
        times[name] = time.perf_counter() - t

    threads = [threading.Thread(target=run, args=a) for a in
               (("native", _build.build_native), ("kernels", _build.build_kernels))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail("build: " + "; ".join(errors))
    for row in _ptxas_report(os.path.join(_build.BUILD_DIR, "kernels_build.log")):
        log(f"  ptxas {row['name']}: {row.get('registers')} registers, "
            f"spills {row.get('spill_stores')} B stored / "
            f"{row.get('spill_loads')} B loaded"
            + (f", {row['smem']} B dynamic shared memory" if "smem" in row else ""))
    times["total"] = time.perf_counter() - t0
    return times


def _ptxas_report(path: str) -> list:
    """Each kernel's registers and spill bytes from nvcc's ``-Xptxas -v``
    log, and for the flash kernels the dynamic shared memory one launch
    takes (which ptxas does not see), as the library reports it."""
    from torchft_tpu_torch import _build
    from torchft_tpu_torch.ops._lib import _kernels

    kinds = {"fwd": 0, "dkdv": 1, "dq": 2}
    names = []  # the kernels the sources declare
    for src in _build.KERNEL_SOURCES:
        with open(src) as f:
            names += re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?"
                                r"(\w+)\(", f.read())
    rows = []
    with open(path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                # mangled: the name follows its length
                name = next((n for n in names if f"{len(n)}{n}" in m.group(1)),
                            m.group(1))
                shape = re.search(r"ILi(\d+)ELi(\d+)E", m.group(1))
                row = {"name": name}
                if name.startswith("flash_") and shape:
                    d, bn = map(int, shape.groups())
                    row["name"] = f"{name}<D{d}, BN{bn}>"
                    kind = kinds[name.split("_")[2 if "bwd" in name else 1]]
                    row["smem"] = _kernels.lib().tft_flash_smem_bytes(
                        kind, 1 if "_mma_" in name else 0, d, bn)
                rows.append(row)
            elif rows:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                              line)
                if m:
                    rows[-1]["spill_stores"], rows[-1]["spill_loads"] = map(
                        int, m.groups())
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    rows[-1]["registers"] = int(m.group(1))
    return rows


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int = 20) -> float:
    """Device time of ``fn``'s launches, replayed as one CUDA graph: the
    per-launch host overhead (Python, ctypes) drops out, so this is the
    kernels' own time back to back."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError as e:
        fail(f"CUDA graph capture failed, no device time to report: {e}")
    return _time_ms(graph.replay, iters=iters)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    both = torch.isfinite(a) & torch.isfinite(b)
    return float((a[both] - b[both]).abs().max()) if both.any() else 0.0


def phase_kernels(device: str = "cuda", timing: bool = True) -> dict:
    from torchft_tpu_torch._tree import flatten
    from torchft_tpu_torch.models import transformer as tt
    from torchft_tpu_torch.ops import quantize_kernels as qk

    dev = torch.device(device)
    cfg = tt.TransformerConfig(**LM)
    shapes = [tuple(p.shape) for p in flatten(tt.init_params(cfg, device="meta"))[0]]
    if len(shapes) != 39:
        fail(f"expected 39 leaves, got {len(shapes)}")
    gen = torch.Generator(device=dev).manual_seed(7)
    grads = [torch.randn(s, generator=gen, device=dev) * 1e-2 for s in shapes]
    ress = [torch.randn(s, generator=gen, device=dev) * 1e-4 for s in shapes]
    nan_bits = torch.tensor(
        [0x7FC00000, 0x7FFFFFFF, 0x7F800001, -0x00400000, -1, 0x7F800000,
         0x3F818000], dtype=torch.int32, device=dev).view(torch.float32)
    specials = {
        "ragged_1000003": torch.randn(1000003, generator=gen, device=dev),
        "all_zero": torch.zeros(4099, device=dev),
        "nan_leaf": torch.tensor([1.0, float("nan"), -2.0], device=dev),
        "inf_leaf": torch.tensor([1.0, float("inf"), 2.0], device=dev),
        "nan_bit_patterns": nan_bits,
    }
    cases = [(f"leaf{i}{list(s)}", x, r) for i, (s, x, r) in
             enumerate(zip(shapes, grads, ress))]
    cases += [(k, x, torch.zeros_like(x)) for k, x in specials.items()]

    err = {"q8_absmax": 0.0, "q8_quantize": 0.0, "q8_dequantize": 0.0,
           "cast_bf16": 0.0}
    for name, x, r in cases:
        a_k, a_p = qk.q8_absmax(x, r), qk.plain["q8_absmax"](x, r)
        if torch.isnan(a_p):  # which NaN is not part of the contract
            ok = bool(torch.isnan(a_k))
        else:
            ok = _bits_equal(a_k, a_p)
            err["q8_absmax"] = max(err["q8_absmax"], _max_abs_err(a_k, a_p))
        if not ok:
            fail(f"K1a q8_absmax disagrees on {name}")
        got = qk.q8_quantize(x, r, a_k)
        want = qk.plain["q8_quantize"](x, r, a_p)
        for part, u, v in zip(("q", "scale", "res"), got, want):
            if not _bits_equal(u, v):
                fail(f"K1b q8_quantize disagrees on {name} ({part})")
            err["q8_quantize"] = max(err["q8_quantize"], _max_abs_err(u, v))
        d_k = qk.dequantize_q8(got[0], got[1])
        d_p = qk.plain["q8_dequantize"](got[0], got[1])
        if not _bits_equal(d_k, d_p):
            fail(f"K2 dequantize_q8 disagrees on {name}")
        err["q8_dequantize"] = max(err["q8_dequantize"], _max_abs_err(d_k, d_p))
        if not _bits_equal(qk.cast_bf16(x), qk.plain["cast_bf16"](x)):
            fail(f"K3 cast_bf16 disagrees on {name}")
    canon = qk.cast_bf16(nan_bits).view(torch.int16).tolist()
    if [v & 0xFFFF for v in canon] != [0x7FC0, 0x7FC0, 0x7FC0, 0xFFC0, 0xFFC0,
                                       0x7F80, 0x3F82]:
        fail(f"K3 NaN bit patterns wrong: {[hex(v & 0xFFFF) for v in canon]}")
    q, s, r = qk.quantize_q8_ef(specials["inf_leaf"], torch.zeros(3, device=dev))
    if q.tolist() != [0, 0, 0] or s.view(torch.int32).item() != 0x7FC00000 or \
            (r.view(torch.int32) != 0x7FC00000).any():
        fail("K1 non-finite leaf does not poison with 0x7FC00000")
    if (qk.dequantize_q8(q, s).view(torch.int32) != 0x7FC00000).any():
        fail("K2 NaN scale does not poison the leaf with 0x7FC00000")
    if qk.dequantize_q8(torch.zeros(0, dtype=torch.int8, device=dev), s).shape != (0,):
        fail("K2 empty leaf")
    # the bf16 wire's one f32 group, as the packer concatenates it
    group = torch.cat([x.reshape(-1) for x in grads])
    b_k, b_p = qk.cast_bf16(group), qk.plain["cast_bf16"](group)
    if not _bits_equal(b_k, b_p):
        fail("K3 cast_bf16 disagrees on the 23.3M-element group")
    err["cast_bf16"] = max(err["cast_bf16"], _max_abs_err(b_k, b_p))
    log(f"  {len(cases)} cases + the bf16 group: K1a, K1b, K2, K3 bit-identical"
        " to their plain versions (K2 on K1b's codes and scales, NaN scale "
        "and empty leaf included)")

    if not timing:
        return {}
    n = sum(x.numel() for x in grads)
    absmaxes = [qk.q8_absmax(x, r) for x, r in zip(grads, ress)]
    neg_ress = [-r for r in ress]
    k1a = lambda: [qk.q8_absmax(x, r) for x, r in zip(grads, ress)]
    k1b = lambda: [qk.q8_quantize(x, r, a) for x, r, a in
                   zip(grads, ress, absmaxes)]
    codes = [qk.q8_quantize(x, r, a)[:2] for x, r, a in
             zip(grads, ress, absmaxes)]
    k2 = lambda: [qk.dequantize_q8(c, sc) for c, sc in codes]
    k3 = lambda: qk.cast_bf16(group)
    log(f"  eager per step (launch overhead included): K1a {_time_ms(k1a):.4f}"
        f" ms, K1b {_time_ms(k1b):.4f} ms, K2 {_time_ms(k2):.4f} ms, "
        f"K3 {_time_ms(k3):.4f} ms")
    # ms, plain ms, library ms: device time of one step's launches (CUDA
    # graph replay), except the plain quantize, which synchronises per
    # leaf and is timed eagerly.
    times = {
        "q8_absmax": (
            _graph_ms(k1a),
            _graph_ms(lambda: [qk.plain["q8_absmax"](x, r)
                               for x, r in zip(grads, ress)]),
            # one PyTorch call computing max|x + res|: max|x - (-res)|
            _graph_ms(lambda: [torch.dist(x, nr, p=float("inf"))
                               for x, nr in zip(grads, neg_ress)]),
            8 * n,   # reads x and res
        ),
        "q8_quantize": (
            _graph_ms(k1b),
            _time_ms(lambda: [qk.plain["q8_quantize"](x, r, a) for x, r, a in
                              zip(grads, ress, absmaxes)], iters=5),
            None,    # no single PyTorch call quantizes with error feedback
            13 * n,  # reads x and res, writes int8 codes and the residual
        ),
        "q8_dequantize": (
            _graph_ms(k2),
            _graph_ms(lambda: [qk.plain["q8_dequantize"](c, sc)
                               for c, sc in codes]),
            # one PyTorch call: int8 codes times the f32 0-d scale
            _graph_ms(lambda: [torch.mul(c, sc) for c, sc in codes]),
            5 * n,   # reads int8 codes, writes f32
        ),
        "cast_bf16": (
            _graph_ms(k3),
            _graph_ms(lambda: qk.plain["cast_bf16"](group)),
            _graph_ms(lambda: group.to(torch.bfloat16)),
            6 * n,   # reads f32, writes bf16
        ),
    }
    rows = {}
    for name, (ms, plain_ms, lib_ms, nbytes) in times.items():
        rows[name] = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCES[name],
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": lib_ms,
        }
        log(f"  {name}: {ms:.4f} ms/step (39 leaves) vs plain {plain_ms:.4f}"
            f" ms, library {lib_ms if lib_ms is None else round(lib_ms, 4)} "
            f"ms, bound {rows[name]['bound_ms']:.4f} ms")
    return rows


def _flash_pairs(S: int, causal: bool, window) -> int:
    """Live (query, key) pairs of one (batch, head) slice."""
    if window is not None:
        w = min(window, S)  # row q sees min(q + 1, w) keys
        return w * (w + 1) // 2 + (S - w) * w
    return S * (S + 1) // 2 if causal else S * S


def _flash_bound(kind: str, shape, dtype, causal: bool, window) -> tuple:
    """(bound ms, what bounds it) of one K4 ("fwd") or K5 ("bwd") call:
    the larger of the minimal operations (2 products of 2 flops per live
    pair and head dim forward, 5 backward) over the dtype's peak, and the
    bytes (forward reads q, k, v and writes out and the f32 lse; backward
    reads q, k, v, out, do and lse and writes dq, dk, dv) over HBM's."""
    B, S, H, D = shape
    flops = (4 if kind == "fwd" else 10) * B * H * _flash_pairs(S, causal, window) * D
    n, elt, rows = B * S * H * D, torch.finfo(dtype).bits // 8, B * H * S
    nbytes = (4 * n * elt + 4 * rows) if kind == "fwd" else (8 * n * elt + 4 * rows)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _flash_tol(name: str, ref: torch.Tensor) -> float:
    """f32: 2e-5 of the tensor's largest magnitude (at least 1), the JAX
    package's flash tolerance (the two sides differ in f32 summation
    order); lse 1e-5 likewise. bf16: two bf16 steps (2**-6) of the
    tensor's largest magnitude: the kernel rounds p to bf16 against each
    tile's running max, the plain version against the row's final max, so
    single elements of p, ds and the outputs may land a step apart."""
    big = float(ref.float().abs().max())
    if name == "lse":
        return 1e-5 * max(1.0, big)
    if ref.dtype == torch.float32:
        return 2e-5 * max(1.0, big)
    return 2.0 ** -6 * big


def _flash_case(tfa, label: str, shape, dtype, causal=True, window=None,
                block_k=None, chunk: int = 2, device: str = "cuda") -> dict:
    """K4 and K5 on the card against their plain versions on the same
    inputs (the plain backward gets the kernel's lse, out and delta), in
    batch chunks of ``chunk`` so the plain (S, S) scores stay small.
    Fails past the tolerance; returns the inputs and errors."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(sum(shape) + (window or 0))
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(4))
    cfg = tfa.FlashConfig(causal, window, *tfa.resolve_blocks(
        shape[1], dev, None, block_k))
    out, lse = tfa.flash_fwd(q, k, v, cfg)
    grads = tfa.flash_bwd(q, k, v, out, lse, do, cfg)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    names = ("out", "lse", "dq", "dk", "dv")
    err = dict.fromkeys(names, 0.0)
    tol = dict.fromkeys(names, 0.0)
    for b0 in range(0, shape[0], chunk):
        sl = slice(b0, b0 + chunk)
        want = (*tfa.flash_fwd_plain(q[sl], k[sl], v[sl], cfg),
                *tfa.flash_bwd_plain(q[sl], k[sl], v[sl], do[sl], lse[sl],
                                     delta[sl], cfg))
        for name, got, ref in zip(names, (out, lse, *grads), want):
            got = got[sl]
            if got.dtype != ref.dtype or got.shape != ref.shape:
                fail(f"flash {label}: {name} is {got.dtype} {tuple(got.shape)}")
            if not torch.isfinite(got).all():
                fail(f"flash {label}: non-finite {name}")
            err[name] = max(err[name], float((got.float() - ref.float()).abs().max()))
            tol[name] = max(tol[name], _flash_tol(name, ref))
    bad = [n for n in names if err[n] > tol[n]]
    log(f"  flash {label} {tuple(shape)} {str(dtype)[6:]} causal={causal} "
        f"window={window} blocks={cfg.block_q}x{cfg.block_k} fast={cfg.fast}: "
        + ", ".join(f"{n} err {err[n]:.3g} (tol {tol[n]:.3g})" for n in names))
    if bad:
        fail(f"flash {label}: {bad} past tolerance")
    return {"q": q, "k": k, "v": v, "do": do, "out": out, "lse": lse,
            "delta": delta, "cfg": cfg, "grads": grads, "err": err}


def _sdpa_forward(q, k, v, causal: bool):
    """One PyTorch call computing K4's output on the same (pre-scaled)
    inputs. Timed only; the port never calls it."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, scale=1.0)


def _sdpa_backward(q, k, v, do, causal: bool):
    """One PyTorch call computing K5's function on the same (pre-scaled)
    inputs: aten's flash-attention backward, given its own forward's out
    and lse. Timed only; the port never calls it."""
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.0, causal, False, scale=1.0)
    out, lse, cq, ck, mq, mk, seed, offset = fwd[:8]
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        dot, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, causal, seed, offset,
        scale=1.0)


def phase_flash_kernels() -> dict:
    import importlib

    tfa = importlib.import_module("torchft_tpu_torch.ops.flash_attention")
    from torchft_tpu_torch.ops._lib import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain f32 products
    B, S, H, D = FLASH_SHAPE
    path = _flash_case(tfa, "path", FLASH_SHAPE, torch.bfloat16)
    _flash_case(tfa, "S2048", (4, S + 1, H, D), torch.bfloat16)
    _flash_case(tfa, "non-causal", (2, S, H, D), torch.bfloat16, causal=False)
    for w in (1, 16, 200, 1000):
        _flash_case(tfa, f"window{w}", (2, S, H, D), torch.bfloat16, window=w)
    _flash_case(tfa, "block_k32", (2, S, H, D), torch.bfloat16, block_k=32)
    _flash_case(tfa, "head_dim128", (2, S, H // 2, 2 * D), torch.bfloat16)
    _flash_case(tfa, "f32", (2, S, H, D), torch.float32)
    q, k, v, do, out, lse, delta, cfg = (path[n] for n in (
        "q", "k", "v", "do", "out", "lse", "delta", "cfg"))
    again = tfa.flash_bwd(q, k, v, out, lse, do, cfg)
    if not all(_bits_equal(a, b) for a, b in zip(path["grads"], again)):
        fail("K5 flash_bwd is not bit-identical run to run")
    log("  K5 run twice on the path's inputs: bit-identical")

    # device times at the path's shape (graph replay; the plain versions,
    # one to a few seconds a call, eagerly)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # the stream is read at each launch: the capture's, not the default
    args = lambda: tfa._kernel_args(cfg, (q, k, v, do))
    split = {
        "dkdv": _graph_ms(lambda: _kernels.launch(
            "flash_bwd", "tft_flash_bwd_dkdv", *ptrs, dk.data_ptr(),
            dv.data_ptr(), *args())),
        "dq": _graph_ms(lambda: _kernels.launch(
            "flash_bwd", "tft_flash_bwd_dq", *ptrs, dq.data_ptr(), *args())),
    }
    times = {
        "flash_fwd": (
            _graph_ms(lambda: tfa.flash_fwd(q, k, v, cfg)),
            _time_ms(lambda: tfa.flash_fwd_plain(q, k, v, cfg), iters=3, warmup=1),
            _graph_ms(_sdpa_forward(q, k, v, True)),
            _flash_bound("fwd", FLASH_SHAPE, torch.bfloat16, True, None),
            max(path["err"]["out"], path["err"]["lse"]),
        ),
        "flash_bwd": (
            _graph_ms(lambda: tfa.flash_bwd(q, k, v, out, lse, do, cfg)),
            _time_ms(lambda: tfa.flash_bwd_plain(q, k, v, do, lse, delta, cfg),
                     iters=2, warmup=1),
            _graph_ms(_sdpa_backward(q, k, v, do, True)),
            _flash_bound("bwd", FLASH_SHAPE, torch.bfloat16, True, None),
            max(path["err"][n] for n in ("dq", "dk", "dv")),
        ),
    }
    rows = {}
    for name, (ms, plain_ms, lib_ms, (bound_ms, bound_by), err) in times.items():
        rows[name] = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCES[name],
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
        }
        log(f"  {name} at {FLASH_SHAPE} bf16 causal: {ms:.3f} ms vs plain "
            f"{plain_ms:.3f} ms, scaled_dot_product_attention {lib_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}; the kernel at "
            f"{bound_ms / ms:.1%} of it)")
    log(f"  flash_bwd split: dk/dv kernel {split['dkdv']:.3f} ms, dq kernel "
        f"{split['dq']:.3f} ms")
    # flops over the path's live (query, key) pairs: 2 per pair and head dim
    # for each product (K4 2, K5 5 minimal; the split executes dk/dv 4, dq 3)
    pair_flops = 2 * B * H * _flash_pairs(S, True, None) * D
    tflops = lambda products, ms: products * pair_flops / ms / 1e9
    log(f"  achieved at {FLASH_SHAPE} (bf16 bound {PEAK_FLOPS[torch.bfloat16] / 1e12:.0f}"
        f" TFLOP/s): K4 {tflops(2, rows['flash_fwd']['ms']):.1f} TFLOP/s; K5 "
        f"{tflops(5, rows['flash_bwd']['ms']):.1f} TFLOP/s of its minimal "
        f"work, the dk/dv kernel {tflops(4, split['dkdv']):.1f} and the dq "
        f"kernel {tflops(3, split['dq']):.1f} of the products each executes "
        f"(4 and 3); scaled_dot_product_attention forward "
        f"{tflops(2, rows['flash_fwd']['library_ms']):.1f}, backward "
        f"{tflops(5, rows['flash_bwd']['library_ms']):.1f}")
    return rows


def _spawn(cfg: dict, logdir: str) -> subprocess.Popen:
    logf = open(os.path.join(logdir, f"worker_{cfg['group']}.log"), "w")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", json.dumps(cfg)],
        cwd=REPO, stdout=logf, stderr=subprocess.STDOUT,
    )


def _join(procs, deadline: float, workdir: str) -> None:
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        fail("a worker did not finish in time")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p in procs:
        if p.returncode != 0:
            g = json.loads(p.args[-1])["group"]
            with open(os.path.join(workdir, f"worker_{g}.log")) as f:
                tail = f.read()[-3000:]
            fail(f"worker {g} exited {p.returncode}:\n{tail}")


def phase_train_and_heal(workdir: str, device: str = "cuda", lm: dict = LM,
                         batch: int = BATCH, seq: int = SEQ) -> dict:
    import torchft_tpu_torch as tft

    lighthouse = tft.Lighthouse(min_replicas=2, join_timeout_ms=10000,
                                quorum_tick_ms=50, heartbeat_timeout_ms=10000)
    base = {"lighthouse": lighthouse.address(), "workdir": workdir,
            "data_offset": 0, "device": device,
            "lm": lm, "batch": batch, "seq": seq}
    t0 = time.perf_counter()
    procs = []
    try:
        procs = [_spawn({**base, "group": g, "role": "founder"}, workdir)
                 for g in (0, 1)]
        deadline = time.monotonic() + 600
        for g in (0, 1):
            path = os.path.join(workdir, f"ready_{g}")
            while not os.path.exists(path):
                if any(p.poll() not in (None, 0) for p in procs):
                    _join(procs, deadline, workdir)
                if time.monotonic() > deadline:
                    fail("founders never finished the train phase")
                time.sleep(0.1)
        t_train = time.perf_counter() - t0
        log(f"  train phase done in {t_train:.1f} s; starting the late joiner")
        procs.append(_spawn({**base, "group": 2, "role": "late"}, workdir))
        _join(procs, deadline, workdir)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        lighthouse.shutdown()
    results = []
    for g in (0, 1, 2):
        with open(os.path.join(workdir, f"result_{g}.json")) as f:
            results.append(json.load(f))
    return {"results": results, "train_s": t_train,
            "total_s": time.perf_counter() - t0}


def check_training(res: dict, expect_leaves: int = 39,
                   on_card: bool = True) -> dict:
    results = res["results"]
    launches = {}
    step_s, compute_s = [], []
    for r in results:
        g, n_leaves = r["group"], r["n_leaves"]
        if n_leaves != expect_leaves:
            fail(f"group {g}: {n_leaves} leaves")
        for phase, ph in r["phases"].items():
            if not all(ph["commits"]) or not ph["commits"]:
                fail(f"group {g} {phase}: uncommitted step {ph['commits']}")
            if not all(map(_finite, ph["losses"])):
                fail(f"group {g} {phase}: non-finite loss {ph['losses']}")
            want = dict.fromkeys(ph["launches"], 0)
            if on_card:  # (on the CPU the plain versions ran: no launches)
                if phase == "bf16":
                    want["cast_bf16"] = ph["dispatches"]
                else:
                    want["q8_absmax"] = want["q8_quantize"] = \
                        n_leaves * ph["dispatches"]
            if ph["launches"] != want:
                fail(f"group {g} {phase}: launches {ph['launches']} != {want}")
            for k, n in ph["launches"].items():
                launches[k] = launches.get(k, 0) + n
            log(f"  group {g} {phase}: {ph['dispatches']} steps committed, "
                f"step {ph['step']}, losses {[round(l, 4) for l in ph['losses']]}"
                f", launches {ph['launches']}")
        if "q8" in r["phases"]:
            # a phase's first step settles nothing: it is not a steady step
            step_s += r["phases"]["q8"]["step_s"][1:]
            compute_s.append(r["compute_s"])
    f0, f1, late = results
    if on_card and not f0.get("trace", {}).get("ring_windows_ms"):
        fail(f"the trace shows no ring window: {f0.get('trace')}")
    for phase in ("warm", "q8", "traced", "bf16", "heal"):
        if f0["phases"][phase]["digest"] != f1["phases"][phase]["digest"]:
            fail(f"founders' parameters differ after the {phase} phase")
    if late["phases"]["heal"]["digest"] != f0["phases"]["heal"]["digest"]:
        fail("the healed group's parameters differ from the donor's")
    if late.get("heals", 0) < 1 or not late.get("fetch"):
        fail(f"the late group never healed: {late.get('heals')} {late.get('fetch')}")
    log(f"  late group healed ({late['fetch']}) and ended bit-identical at "
        f"step {late['phases']['heal']['step']}")
    step_s.sort()
    founders = (f0, f1)
    return {"launches": launches, "step_ms_p50": 1e3 * step_s[len(step_s) // 2],
            "step_ms_all": [round(1e3 * s, 3) for s in step_s],
            # whole timed window (first dispatch to the flush's settle)
            # over its steps, per founder: the throughput a user sees
            "window_ms_per_step": [
                round(1e3 * r["phases"]["q8"]["window_s"]
                      / r["phases"]["q8"]["dispatches"], 3) for r in founders],
            "warm_step_ms": [[round(1e3 * x, 3) for x in
                              r["phases"]["warm"]["step_s"]] for r in founders],
            "warm_timers_ms": f0["phases"]["warm"]["timers_ms"],
            "q8_timers_ms": f0["phases"]["q8"]["timers_ms"],
            "compute_ms": [round(1e3 * s, 3) for s in compute_s],
            "heal_fetch_s": late["fetch"]["fetch_s"],
            "trace": f0.get("trace")}


def phase_flash_train(workdir: str, device: str = "cuda", lm: dict = BIG_LM,
                      batch: int = BIG_BATCH, seq: int = BIG_SEQ) -> dict:
    import torchft_tpu_torch as tft

    lighthouse = tft.Lighthouse(min_replicas=2, join_timeout_ms=10000,
                                quorum_tick_ms=50, heartbeat_timeout_ms=10000)
    base = {"lighthouse": lighthouse.address(), "workdir": workdir,
            "data_offset": 0, "device": device, "role": "flash",
            "lm": lm, "batch": batch, "seq": seq}
    t0 = time.perf_counter()
    procs = []
    try:
        procs = [_spawn({**base, "group": g}, workdir) for g in (0, 1)]
        _join(procs, time.monotonic() + 600, workdir)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        lighthouse.shutdown()
    results = []
    for g in (0, 1):
        with open(os.path.join(workdir, f"result_{g}.json")) as f:
            results.append(json.load(f))
    return {"results": results, "total_s": time.perf_counter() - t0}


def check_flash_training(res: dict, expect_leaves: int = 51,
                         on_card: bool = True) -> dict:
    results = res["results"]
    launches = {}
    step_s = []
    for r in results:
        g, n_leaves, n_layers = r["group"], r["n_leaves"], r["n_layers"]
        if n_leaves != expect_leaves:
            fail(f"flash group {g}: {n_leaves} leaves")
        for phase, ph in r["phases"].items():
            if not all(ph["commits"]) or not ph["commits"]:
                fail(f"flash group {g} {phase}: uncommitted step {ph['commits']}")
            if not all(map(_finite, ph["losses"])):
                fail(f"flash group {g} {phase}: non-finite loss {ph['losses']}")
            # a forward/backward pass per step, and one more for a step
            # whose gradients a heal made stale (the manager's first
            # quorum heals group 1 from group 0: its init sync)
            steps, passes = ph["dispatches"], ph["grad_passes"]
            if passes != steps + sum(ph["heals"].values()):
                fail(f"flash group {g} {phase}: {passes} passes for {steps} "
                     f"steps and heals {ph['heals']}")
            want = dict.fromkeys(ph["launches"], 0)
            if on_card:
                want.update(q8_absmax=n_leaves * steps,
                            q8_quantize=n_leaves * steps,
                            flash_fwd=n_layers * passes,
                            flash_bwd=2 * n_layers * passes)
            if ph["launches"] != want:
                fail(f"flash group {g} {phase}: launches {ph['launches']} != {want}")
            for k, n in ph["launches"].items():
                launches[k] = launches.get(k, 0) + n
            log(f"  flash group {g} {phase}: {steps} steps committed, step "
                f"{ph['step']}, {passes} forward/backward passes (heals "
                f"{ph['heals']}), losses {[round(l, 4) for l in ph['losses']]}"
                f", launches {ph['launches']}")
        step_s += r["phases"]["flash"]["step_s"][1:]
    f0, f1 = results
    for phase in ("warm", "flash", "traced"):
        if f0["phases"][phase]["digest"] != f1["phases"][phase]["digest"]:
            fail(f"flash founders' parameters differ after the {phase} phase")
    traced = [k["name"] for k in (f0.get("trace") or {}).get("flash_kernels", [])]
    missing = [k for k in MMA_KERNELS if not any(k in n for n in traced)]
    if on_card and missing:
        fail(f"the traced flash steps show no {missing} (flash kernels: {traced})")
    fvd = f0["flash_vs_dense"]
    rel = abs(fvd["flash"] - fvd["dense"]) / abs(fvd["dense"])
    if not (_finite(fvd["flash"]) and rel <= FLASH_DENSE_LOSS_RTOL):
        fail(f"flash loss {fvd['flash']} vs dense {fvd['dense']}: rel {rel:.3g}"
             f" > {FLASH_DENSE_LOSS_RTOL:.3g}")
    step_s.sort()
    timers = f0["phases"]["flash"]["timers_ms"]
    return {
        "launches": launches,
        "step_ms_p50": 1e3 * step_s[len(step_s) // 2],
        "step_ms_all": [round(1e3 * s, 3) for s in step_s],
        "window_ms_per_step": [
            round(1e3 * r["phases"]["flash"]["window_s"]
                  / r["phases"]["flash"]["dispatches"], 3) for r in results],
        "plan_allreduce_ms": timers.get("plan_allreduce", {}).get("mean"),
        "timers_ms": timers,
        "compute_ms": [round(1e3 * r["compute_s"], 3) for r in results],
        "max_memory_allocated_gb": [
            round(r.get("max_memory_allocated", 0) / 2**30, 3) for r in results],
        "flash_vs_dense": {**fvd, "rel": rel},
        "trace": f0.get("trace"),
    }


def _finite(v: float) -> bool:
    return v == v and abs(v) != float("inf")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        worker(json.loads(args.worker))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 1
    import torchft_tpu_torch  # noqa: F401 - fails outside a checkout

    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    log("phase build")
    log(f"  built: {json.dumps({k: round(v, 2) for k, v in phase_build().items()})}")
    log("phase kernels")
    rows = phase_kernels()
    log("phase flash kernels")
    rows.update(phase_flash_kernels())
    torch.cuda.empty_cache()  # the card's memory goes to the workers next
    log("phase train + heal")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        res = phase_train_and_heal(workdir)
        summary = check_training(res)
    log(f"  train phase {res['train_s']:.1f} s, train+heal {res['total_s']:.1f} s; "
        f"q8 step p50 {summary['step_ms_p50']:.3f} ms over the steady steps "
        f"(all: {summary['step_ms_all']}); whole timed window "
        f"{summary['window_ms_per_step']} ms/step per founder; "
        f"forward/backward alone {summary['compute_ms']} ms per founder; "
        f"heal fetch {summary['heal_fetch_s']:.3f} s")
    log(f"  warm-up steps (not timed) {summary['warm_step_ms']} ms per founder; "
        f"group 0 transaction timers over them, ms: {summary['warm_timers_ms']}")
    log(f"  group 0 transaction timers over the timed steps, ms: "
        f"{summary['q8_timers_ms']}")
    log(f"  trace of group 0's {TRACED_STEPS} traced steps (card clock): "
        f"{json.dumps(summary['trace'])}")
    log("phase flash train")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_flash_") as workdir:
        fres = phase_flash_train(workdir)
        fsum = check_flash_training(fres)
    log(f"  flash train {fres['total_s']:.1f} s; step p50 "
        f"{fsum['step_ms_p50']:.3f} ms over the steady steps (all: "
        f"{fsum['step_ms_all']}); whole timed window "
        f"{fsum['window_ms_per_step']} ms/step per founder; plan_allreduce "
        f"mean {fsum['plan_allreduce_ms']} ms (group 0); forward/backward "
        f"alone {fsum['compute_ms']} ms per founder; "
        f"max_memory_allocated {fsum['max_memory_allocated_gb']} GiB per "
        f"group; flash vs dense loss {json.dumps(fsum['flash_vs_dense'])}")
    log(f"  group 0 transaction timers over the timed flash steps, ms: "
        f"{fsum['timers_ms']}")
    log(f"  trace of group 0's {TRACED_FLASH_STEPS} traced flash steps (card "
        f"clock): {json.dumps(fsum['trace'])}")
    # each kernel's launches over the main paths' runs (the counts each
    # worker reset just before a path and read just after)
    for name in rows:
        rows[name]["launches"] = (summary["launches"].get(name, 0)
                                  + fsum["launches"].get(name, 0))
    for name in ("q8_absmax", "q8_quantize", "cast_bf16", "flash_fwd",
                 "flash_bwd"):
        if rows[name]["launches"] == 0:
            fail(f"{name} is on a main path and never launched there")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

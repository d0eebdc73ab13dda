"""Where does the non-matmul time of the flagship's step go on the card?
The port's counterpart of ``experiments/ablate_big_shape.py``: each row
is the port's make_train_step (loss, gradients, AdamW in place) at the
flagship's widths, each call timed after its warm-up between CUDA
events on the card's stream. Modes by ``EXP_ABL`` (batch ``EXP_B``, default 8):

  layers  flash LM with n_layers 0/2/4/8: the least-squares slope is the
          per-layer cost, the intercept embedding + readout + loss +
          optimizer
  fused   a dispatch-overhead probe, same compute, fewer launches from
          the host: the eager step (every kernel dispatched by Python)
          against the same step's launches captured once as a CUDA graph
          and replayed (the JAX script's merged vs scan8), at n_layers 0
          and 8. Flash attention, not dense: the dense path's mask
          constant is a host-to-device copy, which a graph capture
          refuses. The replay repeats the captured step's AdamW bias
          corrections (a timing probe, not a trainer); its launches are
          not counted (the wrappers count at capture)
  loss    the head alone (n_layers 0) with three cross-entropy variants:
          take (log_softmax + gather), mask (logsumexp - the target
          logit picked by a compare), onehot (logsumexp - an einsum with
          a one-hot)
  blocks  dense attention, then flash at every key tile the CUDA route
          takes (block_q 64, block_k 64: the fast path; 32: the general
          path), each row naming its path

Every K4/K5 call of a flash row's warm-up is held against its plain
version. A configuration the card cannot hold prints FAIL.

Run alone on the card::

    EXP_ABL=layers python experiments/ablate_big_shape_torch.py

CPU rehearsal (tiny widths; the fused mode's graphs need the card)::

    EXP_ABL=loss python experiments/ablate_big_shape_torch.py --device cpu --size tiny
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import common_torch as ct  # noqa: E402
from torchft_tpu_torch.models import transformer as tt  # noqa: E402
from torchft_tpu_torch.train_state import AdamW  # noqa: E402

MODES = ("layers", "fused", "loss", "blocks")
LOSS_VARIANTS = ("take", "mask", "onehot")


def loss_variant(variant: str) -> Callable:
    """``next_token_loss(logits, targets)`` computed three ways
    (``ablate_big_shape.py:131-157``); all three are the mean next-token
    cross-entropy."""

    def nt_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        if variant == "take":
            logp = torch.log_softmax(logits, dim=-1)
            ll = torch.gather(logp, -1, targets[..., None].long())[..., 0]
            return -torch.mean(ll)
        logz = torch.logsumexp(logits, dim=-1)
        if variant == "mask":
            iota = torch.arange(logits.shape[-1], device=logits.device)
            tgt = iota == targets[..., None]
            picked = torch.sum(torch.where(tgt, logits, 0.0), dim=-1)
            return torch.mean(logz - picked)
        if variant == "onehot":
            oh = F.one_hot(targets.long(), logits.shape[-1]).to(logits.dtype)
            picked = torch.einsum("bsv,bsv->bs", logits, oh)
            return torch.mean(logz - picked)
        raise ValueError(variant)

    return nt_loss


def run(cfg: tt.TransformerConfig, batch: torch.Tensor, label: str,
        device: torch.device, warm: int = 2, iters: int = 8,
        check: Optional[ct.PlainCheck] = None,
        log: Callable = print) -> dict:
    """One configuration's train step, its state threaded through the
    calls; FAIL (and no time) when the card cannot hold it."""
    tx = AdamW(1e-3)
    step = tt.make_train_step(cfg, tx)

    def fresh_state():
        p = tt.init_params(cfg, 0, device)
        return (p, tx.init(p))

    try:
        row = ct.bench(lambda st: step(st[0], st[1], batch)[:2], fresh_state,
                       device, warm, iters, label, check=check, chain=True,
                       log=log)
    except torch.OutOfMemoryError as e:
        log(f"{label}: FAIL {type(e).__name__}: {str(e)[:150]}")
        return {"row": label, "fail": type(e).__name__}
    finally:
        if device.type == "cuda":
            torch.cuda.empty_cache()
    L = cfg.n_layers if cfg.use_flash else 0
    ct.expect_launches(row, device, L * ct.FWD_LAUNCHES, L * ct.BWD_LAUNCHES)
    n_params = tt.param_count(row.pop("out")[0])
    row["param_tflops"] = 6 * n_params * batch.numel() / (row["ms"] / 1e3) / 1e12
    log(f"  -> {row['param_tflops']:.1f} param-TFLOP/s")
    return row


def run_graph(cfg: tt.TransformerConfig, batch: torch.Tensor, label: str,
              device: torch.device, warm: int = 2, iters: int = 16,
              log: Callable = print) -> dict:
    """The train step's launches captured once as a CUDA graph (after
    three eager steps on a side stream) and replayed ``iters`` times."""
    tx = AdamW(1e-3)
    step = tt.make_train_step(cfg, tx)
    params = tt.init_params(cfg, 0, device)
    opt_state = tx.init(params)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(3):
            step(params, opt_state, batch)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step(params, opt_state, batch)
    row = ct.bench(graph.replay, tuple, device, warm, iters, label, log=log)
    row.pop("out")
    row["launches"] = "not counted (graph replays)"
    n_params = tt.param_count(params)
    row["param_tflops"] = 6 * n_params * batch.numel() / (row["ms"] / 1e3) / 1e12
    log(f"  -> {row['param_tflops']:.1f} param-TFLOP/s")
    del graph, params, opt_state
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ct.add_device_args(parser)
    parser.add_argument("--warm", type=int, default=2)
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument("--json", help="also write the rows here")
    args = parser.parse_args(argv)
    device = ct.resolve_device(args.device)
    card = ct.card()
    print(f"device {device}" + (f" ({card['smi']})" if card["smi"] else ""),
          flush=True)
    mode = os.environ.get("EXP_ABL", "layers")
    if mode not in MODES:
        raise SystemExit(f"EXP_ABL must be one of {MODES}, got {mode!r}")
    B = int(os.environ.get("EXP_B", "8"))
    S = ct.BATCH[args.size][1]
    base = {k: v for k, v in ct.SIZES[args.size].items() if k != "n_layers"}
    rng = np.random.default_rng(0)
    batch = torch.from_numpy(rng.integers(
        0, base["vocab_size"], size=(B, S), dtype=np.int64)).to(device)
    check = ct.PlainCheck()
    full_layers = ct.SIZES[args.size]["n_layers"]

    def log(m):
        print(m, flush=True)

    def go(cfg, label):
        return run(cfg, batch, label, device, args.warm, args.iters, check,
                   log=log)

    rows: List[dict] = []
    if mode == "layers":
        for L in sorted({0, 2, 4, full_layers}):
            rows.append(go(tt.TransformerConfig(n_layers=L, use_flash=True,
                                                **base), f"flash L={L} B={B}"))
        done = [(L, r["ms"]) for L, r in zip(sorted({0, 2, 4, full_layers}),
                                             rows) if "ms" in r]
        if len(done) >= 2:
            slope, intercept = np.polyfit(*zip(*done), 1)
            log(f"per layer {slope:.2f} ms, intercept {intercept:.2f} ms "
                "(embedding, readout, loss, optimizer)")
            rows.append({"row": "fit", "per_layer_ms": float(slope),
                         "intercept_ms": float(intercept)})
    elif mode == "fused":
        for L in (0, full_layers):
            cfg = tt.TransformerConfig(n_layers=L, use_flash=True, **base)
            rows.append(run(cfg, batch, f"eager L={L}", device, args.warm,
                            2 * args.iters, check, log=log))
            if device.type == "cuda":
                try:
                    rows.append(run_graph(cfg, batch, f"graph L={L}", device,
                                          args.warm, 2 * args.iters, log=log))
                except RuntimeError as e:  # a capture the card refuses
                    log(f"graph L={L}: FAIL {type(e).__name__}: {str(e)[:300]}")
                    rows.append({"row": f"graph L={L}",
                                 "fail": f"{type(e).__name__}: {e}"})
            else:
                log(f"graph L={L}: a CUDA graph needs the card")
    elif mode == "loss":
        cfg0 = tt.TransformerConfig(n_layers=0, **base)
        for variant in LOSS_VARIANTS:
            orig = tt.next_token_loss
            tt.next_token_loss = loss_variant(variant)
            try:
                rows.append(go(cfg0, f"head loss={variant} B={B}"))
            finally:
                tt.next_token_loss = orig
    else:
        cfg = tt.TransformerConfig(n_layers=full_layers, **base)
        rows.append(go(cfg, f"dense B={B}"))
        for bk in ct.tfa.KERNEL_BLOCKS_K:
            bq = ct.tfa.KERNEL_BLOCK_Q
            row = go(dataclasses.replace(cfg, use_flash=True, flash_block_q=bq,
                                         flash_block_k=bk),
                     f"flash B={B} bq={bq} bk={bk}")
            if "check" in row:
                row["path"] = "/".join(row["check"]["K4"]["paths"])
                log(f"  path {row['path']}")
            rows.append(row)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": str(device), "card": card["smi"],
                       "mode": mode, "batch": B, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

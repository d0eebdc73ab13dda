"""Where does the flagship step's time go on the card? The port's
counterpart of ``experiments/mfu_breakdown.py``: component attribution
for bench.py's 111M-param LM (d_model 1024, H16, L8, d_ff 4096, S 2048,
B 16, flash attention, bf16 compute over f32 masters, AdamW):

  matmul 8192^3     torch.matmul in bf16: what the card sustains (a
                    library call as a yardstick, not a port of anything)
  step_full         the port's make_train_step, its state threaded
                    through the calls (updated in place, as a user's
                    loop runs it; JAX donates and rebinds instead)
  grad_only         make_grad_fn: loss and gradients, no update
  fwd_only          the loss under torch.no_grad
  step_no_attn      the train step with attention replaced by x @ wo
                    (attention's cost by subtraction)
  step_mean_loss    the train step with cross-entropy replaced by
                    mean(logits) (the log-softmax's cost by subtraction)
  attn_standalone   K4 + K5 forward and backward at the in-model shape
                    (B16 S2047 H16 D64), x 8 layers

Each timed call of a row, after its warm-up, is timed between CUDA
events on the card's stream: host dispatch inside the call counts where
the card waits for it, the drain between calls does not. Every K4/K5
call of a row, warm-up and timed, is held against its plain version
between calls, off the clock (``common_torch.PlainCheck``), and each
row's launches are checked (step_no_attn launches neither kernel, the
rows after it do).
Prints param-TFLOP/s and the MFU of step_full against the measured
matmul ceiling and against the datasheet's dense bf16 peak of the card
nvidia-smi names.

Run alone on the card::

    python experiments/mfu_breakdown_torch.py [--warm 2 --iters 8]

CPU rehearsal (tiny widths; its times are the CPU's)::

    python experiments/mfu_breakdown_torch.py --device cpu --size tiny
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import common_torch as ct  # noqa: E402
from torchft_tpu_torch._tree import flatten  # noqa: E402
from torchft_tpu_torch.models import transformer as tt  # noqa: E402
from torchft_tpu_torch.ops import flash_attention  # noqa: E402
from torchft_tpu_torch.train_state import AdamW  # noqa: E402

MATMUL_M = {"flagship": 8192, "tiny": 256}


def no_attention(cfg, p, x):
    """The attention sublayer replaced by its output projection alone
    (``mfu_breakdown.py:124``). ``wqkv`` enters the loss with weight 0:
    the port's train step takes the gradient of every leaf and raises on
    one the loss does not read, so it gets zeros, as ``jax.grad`` gives
    the JAX script's unread ``wqkv`` (one sum a layer, ~3M elements)."""
    return x @ p["wo"].to(cfg.dtype) + 0.0 * p["wqkv"].sum()


def mean_logit_loss(logits, targets):
    """Cross-entropy replaced by the mean logit (``mfu_breakdown.py:134``)."""
    return torch.mean(logits)


def attn_flops(B: int, S: int, H: int, D: int) -> float:
    """The script's causal count of one forward+backward
    (``mfu_breakdown.py:154``): 4 B H S^2 D / 2 forward, 2.5x more
    backward."""
    return 4 * B * H * S * S * D / 2 * 3.5


def run(device: torch.device, size: str = "flagship", warm: int = 2,
        iters: int = 8, matmul_iters: int = 32,
        check: Optional[ct.PlainCheck] = None,
        log: Callable = print) -> dict:
    """Every row, in the JAX script's order; returns them with the MFU
    and the split by subtraction."""
    check = check if check is not None else ct.PlainCheck()
    card = ct.card()
    cfg = tt.TransformerConfig(use_flash=True, **ct.SIZES[size])
    B, S = ct.BATCH[size]
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(B, S), dtype=np.int64)).to(device)
    tx = AdamW(1e-3)
    L = cfg.n_layers
    rows = {}

    def bench(fn, make_args, label, chain=False, n=iters, fwd=0, bwd=0):
        row = ct.bench(fn, make_args, device, warm, n, label, check=check,
                       chain=chain, log=log)
        ct.expect_launches(row, device, fwd, bwd)
        row.pop("out")
        rows[label] = row
        return row["ms"] / 1e3

    # -- the ceiling: a plain big bf16 matmul --
    M = MATMUL_M[size]
    gen = torch.Generator(device=device).manual_seed(1)
    a, b = (torch.randn((M, M), generator=gen, device=device,
                        dtype=torch.bfloat16) for _ in range(2))
    dt = bench(torch.matmul, lambda: (a, b), f"matmul {M}^3", n=matmul_iters)
    ceiling = 2 * M ** 3 / dt
    log(f"  -> {ceiling / 1e12:.1f} TFLOP/s sustained")
    del a, b

    n_params = tt.param_count(tt.init_params(cfg, 0, "cpu"))
    ptf = 6 * n_params * B * S
    log(f"params {n_params / 1e6:.1f}M  param-TFLOP/step {ptf / 1e12:.2f}")

    def fresh_state():
        p = tt.init_params(cfg, 0, device)
        return (p, tx.init(p))

    def step_row(label, fwd, bwd):
        step = tt.make_train_step(cfg, tx)
        return bench(lambda st: step(st[0], st[1], tokens)[:2], fresh_state,
                     label, chain=True, fwd=fwd, bwd=bwd)

    # -- the full step --
    dt_full = step_row("step_full", L, 2 * L)
    peak = ct.DATASHEET_BF16.get(card["name"])
    mfu = {"param_tflops": ptf / dt_full / 1e12,
           "of_matmul_ceiling": ptf / dt_full / ceiling,
           "of_datasheet": ptf / dt_full / peak if peak else None,
           "datasheet_tflops": peak / 1e12 if peak else None}
    log(f"  -> {mfu['param_tflops']:.1f} param-TFLOP/s; MFU "
        f"{mfu['of_matmul_ceiling']:.1%} of the measured matmul ceiling"
        + (f", {mfu['of_datasheet']:.1%} of the datasheet's dense bf16 "
           f"{mfu['datasheet_tflops']:.0f} TFLOP/s" if peak else
           ", datasheet peak: not known for this device"))

    # -- gradients only, then the forward only (same weights, no update) --
    p0 = tt.init_params(cfg, 0, device)
    for leaf in flatten(p0)[0]:
        leaf.requires_grad_(True)
    grad_fn = tt.make_grad_fn(cfg)
    bench(grad_fn, lambda: (p0, tokens), "grad_only", fwd=L, bwd=2 * L)

    def fwd_only(p, t):
        with torch.no_grad():
            return tt.loss_fn(cfg, p, t)

    bench(fwd_only, lambda: (p0, tokens), "fwd_only", fwd=L)
    del p0

    # -- attention's cost by subtraction: the identity-attention model --
    real_attn = tt._attention
    try:
        tt._attention = no_attention
        step_row("step_no_attn", 0, 0)
    finally:
        tt._attention = real_attn

    # -- the cross-entropy's cost by subtraction: the mean-logit loss --
    real_loss = tt.next_token_loss
    try:
        tt.next_token_loss = mean_logit_loss
        step_row("step_mean_loss", L, 2 * L)
    finally:
        tt.next_token_loss = real_loss

    # -- K4 + K5 alone at the in-model shape (S - 1 tokens) --
    Sm, H, D = S - 1, cfg.n_heads, cfg.head_dim
    q, k, v = (torch.randn((B, Sm, H, D), generator=gen, device=device,
                           dtype=torch.bfloat16).requires_grad_(True)
               for _ in range(3))

    def attn_grads(q, k, v):
        out = flash_attention(q, k, v)
        return torch.autograd.grad(out.float().sum(), (q, k, v))

    dt = bench(attn_grads, lambda: (q, k, v), "attn_standalone", fwd=1, bwd=2)
    flop = attn_flops(B, Sm, H, D)
    log(f"  -> x{L} layers = {dt * L * 1000:.1f} ms/step; "
        f"{flop / dt / 1e12:.1f} TFLOP/s eff (causal-counted)")

    ms = {k: r["ms"] for k, r in rows.items()}
    split = {
        "optimizer_ms": ms["step_full"] - ms["grad_only"],
        "backward_ms": ms["grad_only"] - ms["fwd_only"],
        "attention_ms": ms["step_full"] - ms["step_no_attn"],
        "xent_ms": ms["step_full"] - ms["step_mean_loss"],
        "attn_standalone_x_layers_ms": ms["attn_standalone"] * L,
        "attn_tflops": flop / (ms["attn_standalone"] / 1e3) / 1e12,
    }
    log(f"split by subtraction (ms of step_full {ms['step_full']:.2f}): "
        + json.dumps({k: round(v, 3) for k, v in split.items()}))
    return {"device": str(device), "card": card["smi"], "size": size,
            "batch": [B, S], "n_params": n_params,
            "param_tflop_per_step": ptf / 1e12,
            "matmul_tflops": ceiling / 1e12, "mfu": mfu, "split": split,
            "rows": list(rows.values())}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ct.add_device_args(parser)
    parser.add_argument("--warm", type=int, default=2)
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument("--json", help="also write the result here")
    args = parser.parse_args(argv)
    device = ct.resolve_device(args.device)
    card = ct.card()
    print(f"device {device}" + (f" ({card['smi']})" if card["smi"] else ""),
          flush=True)
    res = run(device, args.size, args.warm, args.iters,
              log=lambda m: print(m, flush=True))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

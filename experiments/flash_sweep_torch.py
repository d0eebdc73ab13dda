"""Attention forward+backward on the card: the plain version against the
port's flash kernels at every key tile the CUDA route takes, and against
scaled_dot_product_attention's flash backend; then the whole-model batch
sweep. The port's counterpart of ``experiments/flash_sweep.py``.

attn mode (``EXP_MODE=attn``, the default), at B4 S2048 H16 D64 bf16
causal (the JAX script's shape) and at the flagship's in-model B16 S2047:

  dense             flash_fwd_plain + flash_bwd_plain (with the torch
                    delta): the plain version, the JAX script's "dense"
  ours bq=64 bk=64  K4 + K5 through flash_attention, block_k 64: the fast
                    path (block_q == block_k: the finite -1e30 mask)
  ours bq=64 bk=32  block_k 32: the general path (-inf, isfinite guards)
  sdpa flash        F.scaled_dot_product_attention forward+backward with
                    its backend forced to flash (sdpa_kernel), the library
                    yardstick in place of the JAX script's builtin flash

The CUDA kernels take block_q 64 and block_k 64 or 32
(``KERNEL_BLOCK_Q``, ``KERNEL_BLOCKS_K``), in place of the TPU block
grid (``flash_sweep.py:61-63``). Every K4/K5 call of a kernel row is
held against the plain version between calls, off the clock (its max
abs error and relative Frobenius error printed beside their bf16
bounds), the row's last timed call must give the first call's bits,
and each row names its masking path (S 2047 adds a ragged last tile).

model mode (``EXP_MODE=model``): the whole flagship LM, dense and flash
attention at B 4, 8 and 16: gradients then the AdamW update, steps/s
and param-TFLOP/s (``EXP_ONLY`` filters the variants by name). A variant
the card cannot hold prints FAIL, as in the JAX script.

Run alone on the card::

    python experiments/flash_sweep_torch.py
    EXP_MODE=model python experiments/flash_sweep_torch.py

CPU rehearsal (tiny shapes)::

    python experiments/flash_sweep_torch.py --device cpu --size tiny
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import common_torch as ct  # noqa: E402
from torchft_tpu_torch._tree import flatten  # noqa: E402
from torchft_tpu_torch.models import transformer as tt  # noqa: E402
from torchft_tpu_torch.ops import flash_attention  # noqa: E402
from torchft_tpu_torch.train_state import AdamW  # noqa: E402

tfa = ct.tfa
# (label, (B, S, H, D)) of the attn mode's calls, by size
ATTN_SHAPES = {
    "flagship": [("B4 S2048", (4, 2048, 16, 64)),
                 ("B16 S2047", (16, 2047, 16, 64))],
    "tiny": [("B2 S64", (2, 64, 4, 16)), ("B2 S63", (2, 63, 4, 16))],
}
# model mode: (name, batch, use_flash), flash_sweep.py:100-107
MODEL_VARIANTS = [(f"{kind}_B{b}", b, kind == "flash")
                  for b in (4, 8, 16) for kind in ("dense", "flash")]


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def attn_rows(label: str, shape, device: torch.device, warm: int = 2,
              iters: int = 8, check: Optional[ct.PlainCheck] = None,
              log: Callable = print) -> List[dict]:
    """The attn mode's rows at one shape; raises if a kernel call is off
    its plain version, if a kernel row's last call differs from its
    warm-up's bits, or if a row launched other kernels than its own."""
    check = check if check is not None else ct.PlainCheck()
    B, S, H, D = shape
    n = B * S * H * D
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=device,
                           dtype=torch.bfloat16).requires_grad_(True)
               for _ in range(3))
    log(f"attn {label} {tuple(shape)} bf16 causal, fwd+bwd of sum(out)/{n}")
    rows = []

    # the plain version: the kernels' formulas on dense (S, S) scores
    cfg = tfa.FlashConfig(True, None, *tfa.resolve_blocks(S, device, None,
                                                          None))
    q_s = (q.detach().float() * D ** -0.5).to(q.dtype)
    do = torch.full(shape, 1.0 / n, device=device).to(q.dtype)

    def dense(q_s, k, v):
        out, lse = tfa.flash_fwd_plain(q_s, k, v, cfg)
        delta = tfa.flash_delta_plain(out, do)
        return tfa.flash_bwd_plain(q_s, k, v, do, lse, delta, cfg)

    row = ct.bench(dense, lambda: (q_s, k.detach(), v.detach()), device,
                   warm, iters, f"{label} dense", log=log)
    ct.expect_launches(row, device, 0, 0)
    row["path"] = ct.flash_path(cfg, S) + " (plain)"
    rows.append(row)

    for bk in tfa.KERNEL_BLOCKS_K:
        bq = tfa.KERNEL_BLOCK_Q

        def ours(q, k, v, bq=bq, bk=bk):
            out = flash_attention(q, k, v, block_q=bq, block_k=bk)
            return torch.autograd.grad(out.float().sum() / n, (q, k, v))

        first = []

        def ours_first(q, k, v):
            grads = ours(q, k, v)
            if not first:
                first.extend(g.detach().clone() for g in grads)
            return grads

        row = ct.bench(ours_first, lambda: (q, k, v), device, warm, iters,
                       f"{label} ours bq={bq} bk={bk}", check=check, log=log)
        ct.expect_launches(row, device, ct.FWD_LAUNCHES, ct.BWD_LAUNCHES)
        if not all(_bits_equal(a, b) for a, b in zip(first, row["out"])):
            raise ct.PlainMismatch(f"{row['row']}: the last call's gradients "
                                   "differ from the first's bits")
        row["path"] = "/".join(row["check"]["K4"]["paths"])
        rows.append(row)

    from torch.nn.attention import SDPBackend, sdpa_kernel

    def flash_sdpa(qt, kt, vt):
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            out = F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=D ** -0.5)
            return torch.autograd.grad(out.float().sum() / n,
                                       (qt, kt, vt))

    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    row = ct.bench(flash_sdpa, lambda: (qt, kt, vt), device, warm, iters,
                   f"{label} sdpa flash", log=log)
    ct.expect_launches(row, device, 0, 0)
    row["path"] = "backend FLASH_ATTENTION (forced by sdpa_kernel)"
    log(f"  sdpa backend forced: {row['path']}")
    rows.append(row)
    for r in rows:
        r.pop("out")
        r["shape"] = list(shape)
    return rows


def model_rows(device: torch.device, size: str = "flagship", warm: int = 2,
               iters: int = 8, only: Optional[str] = None,
               check: Optional[ct.PlainCheck] = None,
               log: Callable = print) -> List[dict]:
    """The whole-model batch sweep (``flash_sweep.py:93-159``): gradients
    then the AdamW update, separate calls as the JAX script's two
    programs; a variant that does not fit in the card's memory prints
    FAIL."""
    rng = np.random.default_rng(0)
    tx = AdamW(1e-3)
    S = ct.BATCH[size][1]
    rows = []
    for name, bsz, use_flash in MODEL_VARIANTS:
        if only and only not in name:
            continue
        batch = torch.from_numpy(rng.integers(
            0, ct.SIZES[size]["vocab_size"], size=(bsz, S),
            dtype=np.int64)).to(device)
        cfg = tt.TransformerConfig(use_flash=use_flash, **ct.SIZES[size])
        grad_fn = tt.make_grad_fn(cfg)

        def fresh_state():
            params = tt.init_params(cfg, 0, device)
            for leaf in flatten(params)[0]:
                leaf.requires_grad_(True)
            return params, tx.init(params)

        def step(state):
            _, grads = grad_fn(state[0], batch)
            tx.update_(state[0], state[1], grads)
            return state

        try:
            row = ct.bench(step, fresh_state, device, warm, iters,
                           f"model {name}", check=check, chain=True,
                           log=lambda m: None)
        except torch.OutOfMemoryError as e:
            log(f"model {name}: FAIL {type(e).__name__}: {str(e)[:150]}")
            rows.append({"row": f"model {name}", "fail": type(e).__name__})
            continue
        finally:
            if device.type == "cuda":
                torch.cuda.empty_cache()
        L = cfg.n_layers if use_flash else 0
        ct.expect_launches(row, device, L * ct.FWD_LAUNCHES,
                           L * ct.BWD_LAUNCHES)
        n_params = tt.param_count(row.pop("out")[0])
        row["steps_per_s"] = 1e3 / row["ms"]
        row["param_tflops"] = 6 * n_params * batch.numel() * row["steps_per_s"] / 1e12
        log(f"model {name:12s} {row['steps_per_s']:6.3f} steps/s "
            f"{row['param_tflops']:6.1f} param-TFLOP/s")
        rows.append(row)
    return rows


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

    def log(m):
        print(m, flush=True)

    mode = os.environ.get("EXP_MODE", "attn")
    rows: List[Dict] = []
    if mode == "attn":
        check = ct.PlainCheck()
        for label, shape in ATTN_SHAPES[args.size]:
            rows += attn_rows(label, shape, device, args.warm, args.iters,
                              check, log=log)
    elif mode == "model":
        rows = model_rows(device, args.size, args.warm, args.iters,
                          os.environ.get("EXP_ONLY"), ct.PlainCheck(), log=log)
    else:
        raise SystemExit(f"EXP_MODE must be attn or model, got {mode!r}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": str(device), "card": card["smi"],
                       "mode": mode, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

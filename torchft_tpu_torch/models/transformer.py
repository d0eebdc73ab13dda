"""Decoder-only transformer LM (dense and flash attention paths).

The port of ``torchft_tpu/models/transformer.py``. Parameters keep the
JAX package's tree and layouts, so a JAX checkpoint carries straight
across (:func:`params_from_jax`) and both packages flatten the tree into
the same leaf order for the comm plan:

    {"embed": (V, D), "pos_embed": (S_max, D), "ln_f": {"scale": (D,)},
     "blocks": [{"ln1": {"scale"}, "ln2": {"scale"},
                 "attn": {"wqkv": (D, 3D), "wo": (D, D)},
                 "mlp": {"wi": (D, F), "wo": (F, D)}}, ...]}

Master parameters are f32; matmuls run in ``cfg.dtype`` (bf16 by
default) with weights cast at use, ``x @ w`` with ``w`` laid out
(in, out). Attention is dense by default: einsum scores, a causal mask
and an f32 softmax, as ``transformer.py:313-318`` of the JAX package.
With ``use_flash=True`` it runs through the fused flash-attention kernels
(:func:`torchft_tpu_torch.ops.flash_attention`: no (S, S) score matrix in
device memory), optionally as sliding-window attention
(``attn_window``). ``remat=True`` recomputes each block's activations in
the backward (``torch.utils.checkpoint``, non-reentrant, which
``torch.autograd.grad`` needs); ``remat_policy="save_attn"`` keeps the
attention output (``attn_out``) and the flash operator's ``out``/``lse``
(``flash_out``/``flash_lse``) so the replay skips K4, as the JAX
package's policy does. Context parallelism comes with a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from .._tree import flatten, tree_map, unflatten
from ..ops.flash_attention import (
    checkpoint_name,
    flash_attention,
    save_only_these_names,
)


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_seq_len: int = 1024
    dtype: torch.dtype = torch.bfloat16  # activation/matmul dtype
    # Fused flash attention (torchft_tpu_torch.ops.flash_attention) with
    # its tile overrides (None: the kernel's own tiles) and sliding-window
    # width (None: full causal attention; requires use_flash).
    use_flash: bool = False
    flash_block_q: Optional[int] = None
    flash_block_k: Optional[int] = None
    attn_window: Optional[int] = None
    # Recompute each block's activations in the backward: less memory for
    # about a third more forward work.
    remat: bool = False
    # With remat: "save_attn" keeps each block's attention output and the
    # flash operator's (out, lse) (O(B*S*D) a layer), so the replay skips
    # the forward kernel; on the dense path only the post-projection
    # output is kept. None = full recompute.
    remat_policy: Optional[str] = None

    def __post_init__(self) -> None:
        if self.remat_policy not in (None, "save_attn"):
            raise ValueError(
                f"remat_policy must be None or 'save_attn', got "
                f"{self.remat_policy!r}"
            )
        if self.attn_window is not None and not self.use_flash:
            raise ValueError(
                "attn_window requires use_flash=True (the dense path does "
                "not implement sliding windows)"
            )
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be a multiple of n_heads")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def tiny_config() -> TransformerConfig:
    """Small config for tests."""
    return TransformerConfig(
        vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        max_seq_len=128,
    )


Params = Dict[str, Any]


def init_params(
    cfg: TransformerConfig,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> Params:
    """f32 master parameters from a seeded ``torch.Generator`` (drawn on
    the CPU, then moved, so a seed gives the same weights on any device).
    The scales follow the JAX package; the draws do not (different RNG)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    d, f = cfg.d_model, cfg.d_ff

    def normal(shape: Tuple[int, ...], scale: float) -> torch.Tensor:
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def ones(n: int) -> torch.Tensor:
        return torch.ones(n, device=dev)

    blocks = []
    for _ in range(cfg.n_layers):
        blocks.append({
            "ln1": {"scale": ones(d)},
            "attn": {
                "wqkv": normal((d, 3 * d), d ** -0.5),
                "wo": normal((d, d), d ** -0.5),
            },
            "ln2": {"scale": ones(d)},
            "mlp": {
                "wi": normal((d, f), d ** -0.5),
                "wo": normal((f, d), f ** -0.5),
            },
        })
    return {
        "embed": normal((cfg.vocab_size, d), d ** -0.5),
        "pos_embed": normal((cfg.max_seq_len, d), 0.01),
        "ln_f": {"scale": ones(d)},
        "blocks": blocks,
    }


def params_from_jax(
    tree: Any, device: Optional[Union[str, torch.device]] = None
) -> Params:
    """A JAX parameter tree (numpy or jax leaves, same layout) as f32
    torch tensors on ``device``; pass it to :meth:`TransformerLM.load_params`
    or use it directly with :func:`forward`."""
    dev = resolve_device(device)
    return tree_map(
        lambda l: torch.tensor(np.asarray(l, dtype=np.float32), device=dev),
        tree,
    )


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def _attention(cfg: TransformerConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    B, S, D = x.shape
    qkv = x @ p["wqkv"].to(cfg.dtype)  # (B, S, 3D)
    q, k, v = torch.split(qkv, D, dim=-1)
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_heads, cfg.head_dim)
    if cfg.use_flash:
        out = flash_attention(
            q, k, v, window=cfg.attn_window, block_q=cfg.flash_block_q,
            block_k=cfg.flash_block_k,
        ).reshape(B, S, D)
        return _name_attn_out(cfg, out @ p["wo"].to(cfg.dtype))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (cfg.head_dim ** -0.5)
    causal = torch.tril(torch.ones(S, S, dtype=torch.bool, device=x.device))
    scores = torch.where(
        causal, scores,
        torch.tensor(torch.finfo(scores.dtype).min, dtype=scores.dtype,
                     device=x.device),
    )
    probs = torch.softmax(scores.float(), dim=-1).to(cfg.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, D)
    return _name_attn_out(cfg, out @ p["wo"].to(cfg.dtype))


def _name_attn_out(cfg: TransformerConfig, out: torch.Tensor) -> torch.Tensor:
    """The attention sublayer output, named ``attn_out`` where a policy
    reads the name (the naming is a copy, so only there)."""
    if cfg.remat and cfg.remat_policy == "save_attn":
        return checkpoint_name(out, "attn_out")
    return out


def _mlp(cfg: TransformerConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu(x @ p["wi"].to(cfg.dtype), approximate="tanh")
    return h @ p["wo"].to(cfg.dtype)


def _block(cfg: TransformerConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    x = x + _attention(cfg, p["attn"], _rmsnorm(x, p["ln1"]["scale"]))
    return x + _mlp(cfg, p["mlp"], _rmsnorm(x, p["ln2"]["scale"]))


def remat_wrap(cfg: TransformerConfig, fn: Callable) -> Callable:
    """``fn(cfg, p, x)`` under cfg's remat settings: unchanged without
    remat; else recomputed in the backward, keeping only ``attn_out``,
    ``flash_out`` and ``flash_lse`` under ``remat_policy="save_attn"``."""
    if not cfg.remat:
        return fn
    kwargs: Dict[str, Any] = {}
    if cfg.remat_policy == "save_attn":
        kwargs["context_fn"] = save_only_these_names(
            "attn_out", "flash_out", "flash_lse")

    def wrapped(cfg: TransformerConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
        return checkpoint(fn, cfg, p, x, use_reentrant=False, **kwargs)

    return wrapped


def forward(cfg: TransformerConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) f32."""
    S = tokens.shape[1]
    x = params["embed"].to(cfg.dtype)[tokens]
    x = x + params["pos_embed"].to(cfg.dtype)[:S]
    block = remat_wrap(cfg, _block)
    for p in params["blocks"]:
        x = block(cfg, p, x)
    x = _rmsnorm(x, params["ln_f"]["scale"])
    # weight-tied readout; f32 logits for a stable softmax
    return (x @ params["embed"].to(cfg.dtype).T).float()


def loss_fn(cfg: TransformerConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy over (B, S) int tokens."""
    logits = forward(cfg, params, tokens[:, :-1])
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    return -torch.mean(ll)


def make_grad_fn(cfg: TransformerConfig):
    """``grad_fn(params, tokens) -> (loss, grads)``: fresh gradient
    tensors (``torch.autograd.grad``), so a pipelined caller may hold one
    step's gradients while computing the next."""

    def grad_fn(params: Params, tokens: torch.Tensor) -> Tuple[torch.Tensor, Params]:
        leaves, treedef = flatten(params)
        loss = loss_fn(cfg, params, tokens)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), unflatten(treedef, list(grads))

    return grad_fn


def make_train_step(cfg: TransformerConfig, tx: Any,
                    bf16_params: bool = False):
    """One call for loss, gradients and the optimizer update (the JAX
    package's fused train step), for window strategies that have no
    per-step cross-group work (``LocalSGD.step_applied``).

    ``bf16_params``: mixed precision with a master copy. The gradient
    pass reads a bf16 working copy of the f32 params (one cast pass, not
    one per use); the optimizer (``tx.update_``, e.g. ``AdamW``) updates
    the f32 masters in place, which ``params`` stay throughout. The
    forward is the default's (weights are cast to ``cfg.dtype`` at use
    anyway); what changes is gradient accumulation, which runs in bf16.

    Returns ``step(params, opt_state, tokens) -> (params, opt_state,
    loss)``; ``params`` and ``opt_state`` are the ones passed in,
    updated in place."""

    def step(params: Params, opt_state: Any,
             tokens: torch.Tensor) -> Tuple[Params, Any, torch.Tensor]:
        leaves, treedef = flatten(params)
        with torch.no_grad():
            work = [
                l.detach().to(torch.bfloat16)
                if bf16_params and l.dtype == torch.float32 else l.detach()
                for l in leaves
            ]
        for w in work:
            w.requires_grad_(True)
        loss = loss_fn(cfg, unflatten(treedef, work), tokens)
        grads = torch.autograd.grad(loss, work)
        grads = [g.to(m.dtype) for g, m in zip(grads, leaves)]
        tx.update_(params, opt_state, unflatten(treedef, grads))
        return params, opt_state, loss.detach()

    return step


class _Block(nn.Module):
    def __init__(self, p: Params) -> None:
        super().__init__()
        self.ln1 = nn.ParameterDict({"scale": nn.Parameter(p["ln1"]["scale"])})
        self.attn = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in p["attn"].items()}
        )
        self.ln2 = nn.ParameterDict({"scale": nn.Parameter(p["ln2"]["scale"])})
        self.mlp = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in p["mlp"].items()}
        )

    def params(self) -> Params:
        return {
            "ln1": {"scale": self.ln1["scale"]},
            "attn": {k: self.attn[k] for k in self.attn},
            "ln2": {"scale": self.ln2["scale"]},
            "mlp": {k: self.mlp[k] for k in self.mlp},
        }


class TransformerLM(nn.Module):
    """The LM as an ``nn.Module``: its parameters ARE the tree that
    :meth:`params` returns (the same ``nn.Parameter`` objects), so an
    :class:`~torchft_tpu_torch.train_state.FTTrainState` built over
    ``model.params()`` updates the module in place."""

    def __init__(
        self,
        cfg: TransformerConfig,
        seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__()
        self.cfg = cfg
        p = init_params(cfg, seed, device)
        self.embed = nn.Parameter(p["embed"])
        self.pos_embed = nn.Parameter(p["pos_embed"])
        self.ln_f = nn.ParameterDict({"scale": nn.Parameter(p["ln_f"]["scale"])})
        self.blocks = nn.ModuleList([_Block(b) for b in p["blocks"]])

    def params(self) -> Params:
        return {
            "embed": self.embed,
            "pos_embed": self.pos_embed,
            "ln_f": {"scale": self.ln_f["scale"]},
            "blocks": [b.params() for b in self.blocks],
        }

    @torch.no_grad()
    def load_params(self, tree: Params) -> None:
        """Copies a parameter tree (e.g. :func:`params_from_jax`) in."""
        dst, dst_def = flatten(self.params())
        src, src_def = flatten(tree)
        if dst_def != src_def:
            raise ValueError("parameter tree structure mismatch")
        for d, s in zip(dst, src):
            d.copy_(torch.as_tensor(s))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.cfg, self.params(), tokens)

    def loss(self, tokens: torch.Tensor) -> torch.Tensor:
        return loss_fn(self.cfg, self.params(), tokens)


def param_count(params: Params) -> int:
    return sum(l.numel() for l in flatten(params)[0])


__all__: List[str] = [
    "TransformerConfig",
    "TransformerLM",
    "forward",
    "init_params",
    "loss_fn",
    "make_grad_fn",
    "param_count",
    "params_from_jax",
    "remat_wrap",
    "tiny_config",
]

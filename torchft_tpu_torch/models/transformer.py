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
package's policy does.

Parallelism (:mod:`torchft_tpu_torch.parallel`): ``cfg.cp_mesh`` is this
rank's :class:`~torchft_tpu_torch.parallel.Mesh` and the params are its
blocks under :func:`param_sharding_rules` (Megatron's layout over a
``model`` axis, the JAX package's rule tree). With a ``model`` axis the
forward is tensor parallel: the embedding lookup (``embed`` split along
``d_model``) is gathered, the fused ``wqkv`` columns are regrouped by
head (one uneven all-to-all of the weight: a rank's column block holds
whole q/k/v segments of other ranks' heads), each rank attends over its
``H/tp`` heads, and the row-parallel ``wo`` products, the ``wi``/``wo``
MLP and the tied readout's partial products are all-reduced. With
``cp_seq_axis`` each rank holds its block of the sequence (positions
offset to it) and attention runs as ring attention or Ulysses
(``cp_strategy``); the flash kernels run on whatever heads and rows the
rank holds (``cp_batch_axis`` / ``cp_head_axis`` name that layout, as
the JAX kernel's ``shard_map`` arguments do).
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
from ..parallel import Mesh, all_gather, all_reduce, all_to_all_v

# the mesh axis tensor parallelism splits heads and widths over
TP_AXIS = "model"


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_seq_len: int = 1024
    dtype: torch.dtype = torch.bfloat16  # activation/matmul dtype
    # Parallelism: cp_mesh is this rank's Mesh (tensor parallel over its
    # "model" axis when it has one). Context parallelism when cp_seq_axis
    # names a mesh axis: the sequence is split over it and attention runs
    # as ring attention or Ulysses (cp_strategy). cp_batch_axis and
    # cp_head_axis name the axes the rows and heads are split over (the
    # flash kernel's mesh arguments).
    cp_seq_axis: Optional[str] = None
    cp_mesh: Optional[Mesh] = None
    cp_batch_axis: Optional[str] = "data"
    cp_head_axis: Optional[str] = None
    # "ring" (k/v ppermute + online softmax) or "ulysses" (head/sequence
    # all-to-alls around full-sequence attention, through the flash
    # kernels when use_flash)
    cp_strategy: str = "ring"
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
        if self.cp_strategy not in ("ring", "ulysses"):
            raise ValueError(
                f"cp_strategy must be 'ring' or 'ulysses', got "
                f"{self.cp_strategy!r}"
            )
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
        if self.attn_window is not None and self.cp_seq_axis is not None:
            raise ValueError(
                "attn_window is not implemented on the context-parallel "
                "paths (ring/ulysses take the attention branch before the "
                "flash kernel); unset cp_seq_axis or attn_window"
            )
        if self.cp_seq_axis is not None and self.cp_mesh is None:
            raise ValueError("cp_seq_axis needs cp_mesh (this rank's Mesh)")
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


def _tp_mesh(cfg: TransformerConfig) -> Optional[Mesh]:
    """This rank's mesh when it splits the model over ``model``."""
    mesh = cfg.cp_mesh
    return mesh if mesh is not None and mesh.has_axis(TP_AXIS) else None


def _qkv_heads(w: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's fused ``wqkv`` column block (D, 3D/tp) regrouped into
    ``[q | k | v]`` of its own heads. Seen as 3*tp segments of D/tp
    columns, segment ``j`` sits on rank ``j // 3`` and belongs to head
    group ``j % tp``: one uneven all-to-all of the weight moves each
    segment to its head group (a permutation, so its backward moves the
    gradient back)."""
    tp, r = mesh.axis_size(TP_AXIS), mesh.axis_index(TP_AXIS)
    seg = w.shape[1] // 3
    dest = [(3 * r + i) % tp for i in range(3)]
    order = sorted(range(3), key=lambda i: dest[i])
    send = torch.cat([w[:, i * seg:(i + 1) * seg] for i in order], dim=1)
    in_splits = [dest.count(d) * seg for d in range(tp)]
    out_splits = [sum(1 for j in range(3 * s, 3 * s + 3) if j % tp == r) * seg
                  for s in range(tp)]
    # rows are columns: the move runs along dimension 0
    recv = all_to_all_v(send.t(), mesh, TP_AXIS, in_splits, out_splits)
    return recv.t()


def _seq_offset(cfg: TransformerConfig, S: int) -> int:
    """The position of this rank's first token (its sequence block)."""
    if cfg.cp_seq_axis is None:
        return 0
    return cfg.cp_mesh.axis_index(cfg.cp_seq_axis) * S


def _attention(cfg: TransformerConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    mesh = _tp_mesh(cfg)
    w = p["wqkv"].to(cfg.dtype)
    if mesh is not None:
        w = _qkv_heads(w, mesh)
    qkv = x @ w  # (B, S, 3D/tp)
    Dl = qkv.shape[-1] // 3
    Hl = Dl // cfg.head_dim
    q, k, v = torch.split(qkv, Dl, dim=-1)
    q = q.reshape(B, S, Hl, cfg.head_dim)
    k = k.reshape(B, S, Hl, cfg.head_dim)
    v = v.reshape(B, S, Hl, cfg.head_dim)
    if cfg.cp_seq_axis is not None:
        from ..context_parallel import ring_attention, ulysses_attention

        if cfg.cp_strategy == "ulysses":
            out = ulysses_attention(
                q, k, v, mesh=cfg.cp_mesh, seq_axis=cfg.cp_seq_axis,
                batch_axis=cfg.cp_batch_axis, head_axis=cfg.cp_head_axis,
                use_flash=cfg.use_flash, block_q=cfg.flash_block_q,
                block_k=cfg.flash_block_k,
            )
        else:
            out = ring_attention(
                q, k, v, mesh=cfg.cp_mesh, seq_axis=cfg.cp_seq_axis,
                batch_axis=cfg.cp_batch_axis, head_axis=cfg.cp_head_axis,
            )
    elif cfg.use_flash:
        mesh_axes = cfg.cp_mesh.shape if cfg.cp_mesh is not None else {}
        out = flash_attention(
            q, k, v, window=cfg.attn_window, block_q=cfg.flash_block_q,
            block_k=cfg.flash_block_k, mesh=cfg.cp_mesh,
            batch_axis=cfg.cp_batch_axis if cfg.cp_batch_axis in mesh_axes
            else None,
            head_axis=cfg.cp_head_axis,
        )
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (cfg.head_dim ** -0.5)
        causal = torch.tril(torch.ones(S, S, dtype=torch.bool, device=x.device))
        scores = torch.where(
            causal, scores,
            torch.tensor(torch.finfo(scores.dtype).min, dtype=scores.dtype,
                         device=x.device),
        )
        probs = torch.softmax(scores.float(), dim=-1).to(cfg.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    out = out.reshape(B, S, Dl) @ p["wo"].to(cfg.dtype)
    if mesh is not None:  # row-parallel: each rank's heads' partial sum
        out = all_reduce(out, mesh, TP_AXIS)
    return _name_attn_out(cfg, out)


def _name_attn_out(cfg: TransformerConfig, out: torch.Tensor) -> torch.Tensor:
    """The attention sublayer output, named ``attn_out`` where a policy
    reads the name (the naming is a copy, so only there)."""
    if cfg.remat and cfg.remat_policy == "save_attn":
        return checkpoint_name(out, "attn_out")
    return out


def mlp_apply(cfg: TransformerConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu(x @ p["wi"].to(cfg.dtype), approximate="tanh")
    y = h @ p["wo"].to(cfg.dtype)
    mesh = _tp_mesh(cfg)
    return all_reduce(y, mesh, TP_AXIS) if mesh is not None else y



def _block(cfg: TransformerConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    x = x + _attention(cfg, p["attn"], _rmsnorm(x, p["ln1"]["scale"]))
    return x + mlp_apply(cfg, p["mlp"], _rmsnorm(x, p["ln2"]["scale"]))


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


def embed_tokens(cfg: TransformerConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) int tokens -> (B, S, D) activations in ``cfg.dtype``; under
    context parallelism the tokens are this rank's sequence block and
    take its positions. Tensor parallel: each rank looks up its
    ``d_model`` block, gathered."""
    S = tokens.shape[1]
    x = params["embed"].to(cfg.dtype)[tokens]
    mesh = _tp_mesh(cfg)
    if mesh is not None:
        x = all_gather(x, mesh, TP_AXIS, dim=-1)
    at = _seq_offset(cfg, S)
    return x + params["pos_embed"].to(cfg.dtype)[at:at + S]


def readout(cfg: TransformerConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final norm and weight-tied readout; f32 logits. Tensor parallel:
    each rank's ``d_model`` block's partial products, all-reduced in
    f32."""
    x = _rmsnorm(x, params["ln_f"]["scale"])
    emb = params["embed"].to(cfg.dtype)
    mesh = _tp_mesh(cfg)
    if mesh is None:
        return (x @ emb.T).float()
    d, r = emb.shape[1], mesh.axis_index(TP_AXIS)
    part = (x[..., r * d:(r + 1) * d] @ emb.T).float()
    return all_reduce(part, mesh, TP_AXIS)


def next_token_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return -torch.mean(ll)


def forward(cfg: TransformerConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) f32 (under context
    parallelism: this rank's sequence block of each)."""
    x = embed_tokens(cfg, params, tokens)
    block = remat_wrap(cfg, _block)
    for p in params["blocks"]:
        x = block(cfg, p, x)
    return readout(cfg, params, x)


def shift_tokens(cfg: TransformerConfig,
                 tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inputs, targets) of next-token prediction over (B, S+1) tokens:
    under context parallelism this rank's sequence block of each."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if cfg.cp_seq_axis is not None:
        from ..context_parallel import split_sequence

        inputs = split_sequence(inputs, cfg.cp_mesh, cfg.cp_seq_axis)
        targets = split_sequence(targets, cfg.cp_mesh, cfg.cp_seq_axis)
    return inputs, targets


def loss_fn(cfg: TransformerConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy over (B, S) int tokens (this rank's mean
    under context parallelism: its sequence block's)."""
    inputs, targets = shift_tokens(cfg, tokens)
    return next_token_loss(forward(cfg, params, inputs), targets)


def backbone_specs() -> Dict[str, Any]:
    return {"embed": (None, TP_AXIS), "pos_embed": (), "ln_f": {"scale": ()}}


def attn_sublayer_specs() -> Dict[str, Any]:
    """Megatron attention specs; shared with the MoE family."""
    return {
        "ln1": {"scale": ()},
        "attn": {
            "wqkv": (None, TP_AXIS),  # column-parallel: heads split
            "wo": (TP_AXIS, None),    # row-parallel: partial sums reduced
        },
        "ln2": {"scale": ()},
    }


def mlp_specs() -> Dict[str, Any]:
    return {"wi": (None, TP_AXIS), "wo": (TP_AXIS, None)}


def param_sharding_rules(cfg: TransformerConfig) -> Dict[str, Any]:
    """Per-leaf specs (a tree matching :func:`init_params`) for a mesh
    with a ``model`` axis: Megatron column/row parallelism; replicated
    leaves get ``()``. The JAX package's rule tree, ``PartitionSpec`` s as
    tuples."""
    block = attn_sublayer_specs()
    block["mlp"] = mlp_specs()
    rules = backbone_specs()
    rules["blocks"] = [block] * cfg.n_layers
    return rules


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
    "attn_sublayer_specs",
    "backbone_specs",
    "embed_tokens",
    "forward",
    "init_params",
    "loss_fn",
    "make_grad_fn",
    "mlp_apply",
    "mlp_specs",
    "next_token_loss",
    "param_count",
    "param_sharding_rules",
    "params_from_jax",
    "readout",
    "remat_wrap",
    "shift_tokens",
    "tiny_config",
]

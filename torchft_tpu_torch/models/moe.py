"""Mixture-of-Experts transformer: the expert-parallel model family.

The port of ``torchft_tpu/models/moe.py``: the GShard/Switch layer with
static shapes and one-hot einsum dispatch and combine. Top-k routing in
f32 over ``n_experts`` with a capacity per expert (claims over it are
dropped: their combine weight is zero), the kept gates renormalised,
tanh GELU experts, and the Switch load-balance loss on the top-1
assignment.

The JAX function's meaning is global: ``C = capacity(N)`` counts every
token of the batch, and a claim's slot counts every earlier claim of the
batch (token-major, then k). Here each rank holds its block of the
tokens (its ``cp_batch_axis`` rows and, under context parallelism, its
``cp_seq_axis`` block of each row), so the capacity takes the global
count, and each rank's slots start after the claims of the tokens before
its own: the per-row claim counts of lower sequence blocks (an
all-gather over the sequence axis) and the claims of lower data ranks
(an all-gather of per-expert totals), added before the local cumsum.

Expert weights ``(E, ...)`` are split over the ``expert`` axis of
``cfg.cp_mesh`` (:func:`param_sharding_rules`; their inner width over
``model``). A rank's tokens are replicated over the expert axis, as the
JAX layout has them (the batch is split over ``data`` only), so each rank
runs its own experts on the slots its dispatch fills and the combined
outputs' partial sums meet in an all-reduce over ``expert`` (and
``model``). A mesh without an ``expert`` axis keeps the experts
replicated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..parallel import _raw_all_gather, _raw_all_reduce, all_reduce
from .transformer import (
    TP_AXIS,
    TransformerConfig,
    _attention,
    _rmsnorm,
    attn_sublayer_specs,
    backbone_specs,
    embed_tokens,
    mlp_apply,
    mlp_specs,
    next_token_loss,
    params_from_jax,
    readout,
    remat_wrap,
    shift_tokens,
)

EXPERT_AXIS = "expert"
Params = Dict[str, Any]


@dataclass(frozen=True)
class MoEConfig(TransformerConfig):
    n_experts: int = 8
    router_k: int = 2          # experts per token
    capacity_factor: float = 1.25
    aux_coef: float = 1e-2     # load-balance loss weight
    # every block's MLP is an MoE layer when True; else blocks 1, 3, 5, ...
    moe_every_block: bool = False

    def capacity(self, n_tokens: int) -> int:
        cap = int(self.capacity_factor * self.router_k * n_tokens
                  / self.n_experts)
        return max(1, min(cap, n_tokens))

    def is_moe_block(self, i: int) -> bool:
        return self.moe_every_block or (i % 2 == 1)


def tiny_moe_config() -> MoEConfig:
    return MoEConfig(
        vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        max_seq_len=128, n_experts=4, router_k=2,
    )


def init_params(
    cfg: MoEConfig,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> Params:
    """The dense flagship's skeleton; MoE blocks carry a router and
    stacked expert weights instead of one MLP. f32, drawn from a seeded
    ``torch.Generator`` with the JAX package's scales (not its draws)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def normal(shape: Tuple[int, ...], scale: float) -> torch.Tensor:
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    params: Params = {
        "embed": normal((cfg.vocab_size, d), d ** -0.5),
        "pos_embed": normal((cfg.max_seq_len, d), 0.01),
        "ln_f": {"scale": torch.ones(d, device=dev)},
    }
    blocks = []
    for i in range(cfg.n_layers):
        block: Params = {
            "ln1": {"scale": torch.ones(d, device=dev)},
            "attn": {"wqkv": normal((d, 3 * d), d ** -0.5),
                     "wo": normal((d, d), d ** -0.5)},
            "ln2": {"scale": torch.ones(d, device=dev)},
        }
        if cfg.is_moe_block(i):
            block["moe"] = {
                "router": normal((d, E), d ** -0.5),
                "wi": normal((E, d, f), d ** -0.5),
                "wo": normal((E, f, d), f ** -0.5),
            }
        else:
            block["mlp"] = {"wi": normal((d, f), d ** -0.5),
                            "wo": normal((f, d), f ** -0.5)}
        blocks.append(block)
    params["blocks"] = blocks
    return params


def param_sharding_rules(cfg: MoEConfig) -> Dict[str, Any]:
    """Experts over ``expert``, their inner width over ``model`` (EP x
    TP); the dense layers Megatron-style as in the flagship."""
    blocks = []
    for i in range(cfg.n_layers):
        block = attn_sublayer_specs()
        if cfg.is_moe_block(i):
            block["moe"] = {
                "router": (),
                "wi": (EXPERT_AXIS, None, TP_AXIS),
                "wo": (EXPERT_AXIS, TP_AXIS, None),
            }
        else:
            block["mlp"] = mlp_specs()
        blocks.append(block)
    rules = backbone_specs()
    rules["blocks"] = blocks
    return rules


def _split_axis(cfg: MoEConfig, axis: Optional[str]) -> Optional[str]:
    mesh = cfg.cp_mesh
    return axis if mesh is not None and mesh.has_axis(axis) else None


def _slot_offsets(cfg: MoEConfig, claims: torch.Tensor) -> torch.Tensor:
    """(B, E) count of the claims on each expert that come before each of
    this rank's rows, over the whole batch (``claims``: (B, S*K, E) of
    this rank's tokens, token-major then k)."""
    mesh = cfg.cp_mesh
    d_ax = _split_axis(cfg, cfg.cp_batch_axis)
    s_ax = _split_axis(cfg, cfg.cp_seq_axis)
    row = claims.sum(dim=1)  # (B, E)
    lower = torch.zeros_like(row)
    if s_ax is not None:  # earlier sequence blocks of the same rows
        g = _raw_all_gather(row[None], mesh, s_ax, 0)  # (n_seq, B, E)
        lower = g[:mesh.axis_index(s_ax)].sum(dim=0)
        row = g.sum(dim=0)
    offsets = torch.cumsum(row, dim=0) - row + lower  # earlier rows
    if d_ax is not None:  # every row of lower data ranks
        g = _raw_all_gather(row.sum(dim=0)[None], mesh, d_ax, 0)  # (n_data, E)
        offsets = offsets + g[:mesh.axis_index(d_ax)].sum(dim=0)
    return offsets


def _global_mean(cfg: MoEConfig, x: torch.Tensor, grad: bool) -> torch.Tensor:
    """The mean over the token-split ranks of equal-sized local means."""
    mesh = cfg.cp_mesh
    for axis in (_split_axis(cfg, cfg.cp_batch_axis),
                 _split_axis(cfg, cfg.cp_seq_axis)):
        if axis is not None:
            x = (all_reduce(x, mesh, axis) if grad
                 else _raw_all_reduce(x, mesh, axis)) / mesh.axis_size(axis)
    return x


def moe_layer(
    cfg: MoEConfig, p: Params, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed expert MLP on this rank's (B, S, D) activations.
    Returns ((B, S, D) output, scalar load-balance aux loss)."""
    B, S, D = x.shape
    N = B * S
    E, K = cfg.n_experts, cfg.router_k
    mesh = cfg.cp_mesh
    n_split = 1
    for axis in (_split_axis(cfg, cfg.cp_batch_axis),
                 _split_axis(cfg, cfg.cp_seq_axis)):
        if axis is not None:
            n_split *= mesh.axis_size(axis)
    C = cfg.capacity(N * n_split)
    tokens = x.reshape(N, D)

    # router in f32 for a stable softmax
    logits = tokens.float() @ p["router"].float()  # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)  # (N, K)

    # each (token, k) claim's slot in its expert's buffer: the count of
    # earlier claims on that expert across the whole batch
    one_hot = F.one_hot(gate_idx, E).float()  # (N, K, E)
    claims = one_hot.reshape(B, S * K, E)
    pos = torch.cumsum(claims, dim=1) - claims + _slot_offsets(
        cfg, claims)[:, None, :]
    pos_in_expert = (pos.reshape(N, K, E) * one_hot).sum(dim=-1)  # (N, K)
    keep = pos_in_expert < C  # over-capacity claims dropped

    # renormalise the kept gates so each token's weights sum to 1
    gates = gate_vals * keep
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)

    slot = torch.where(keep, pos_in_expert, torch.zeros_like(pos_in_expert))
    slot_oh = F.one_hot(slot.long(), C).float() * keep[..., None]  # (N, K, C)
    combine = torch.einsum("nke,nkc->nec", one_hot * gates[..., None], slot_oh)
    dispatch = torch.einsum("nke,nkc->nec", one_hot, slot_oh)

    # this rank's experts (all of them when the weights are whole)
    E_local = p["wi"].shape[0]
    ep = E_local != E
    if ep:
        lo = mesh.axis_index(EXPERT_AXIS) * E_local
        dispatch = dispatch[:, lo:lo + E_local]
        combine = combine[:, lo:lo + E_local]
    tp = p["wi"].shape[2] != cfg.d_ff

    xe = torch.einsum("nec,nd->ecd", dispatch.to(cfg.dtype),
                      tokens.to(cfg.dtype))
    h = torch.einsum("ecd,edf->ecf", xe, p["wi"].to(cfg.dtype))
    h = F.gelu(h, approximate="tanh")
    ye = torch.einsum("ecf,efd->ecd", h, p["wo"].to(cfg.dtype))
    if ep or tp:
        # partial sums over this rank's experts (and width): reduced in
        # f32 and rounded once
        out = torch.einsum("nec,ecd->nd", combine.to(cfg.dtype).float(),
                           ye.float())
        if ep:
            out = all_reduce(out, mesh, EXPERT_AXIS)
        if tp:
            out = all_reduce(out, mesh, TP_AXIS)
        out = out.to(cfg.dtype)
    else:
        out = torch.einsum("nec,ecd->nd", combine.to(cfg.dtype), ye)

    # Switch load balance: E * sum_e (fraction routed to e, top-1) *
    # (mean router prob of e), both over the whole batch
    frac_routed = _global_mean(cfg, one_hot[:, 0, :].mean(dim=0), grad=False)
    mean_prob = _global_mean(cfg, probs.mean(dim=0), grad=True)
    aux = E * torch.sum(frac_routed * mean_prob)
    return out.reshape(B, S, D).to(x.dtype), aux


def _block(cfg: MoEConfig, i: int, p: Params,
           x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x + _attention(cfg, p["attn"], _rmsnorm(x, p["ln1"]["scale"]))
    h = _rmsnorm(x, p["ln2"]["scale"])
    if cfg.is_moe_block(i):
        y, aux = moe_layer(cfg, p["moe"], h)
        return x + y, aux
    return x + mlp_apply(cfg, p["mlp"], h), torch.zeros((), device=x.device)


def forward(cfg: MoEConfig, params: Params,
            tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) int -> (logits (B, S, vocab) f32, aux loss)."""
    x = embed_tokens(cfg, params, tokens)
    aux_total = torch.zeros((), device=x.device)
    for i, p in enumerate(params["blocks"]):
        block = remat_wrap(cfg, lambda c, pp, xx, i=i: _block(c, i, pp, xx))
        x, aux = block(cfg, p, x)
        aux_total = aux_total + aux
    return readout(cfg, params, x), aux_total


def loss_fn(cfg: MoEConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy plus the load-balance aux."""
    inputs, targets = shift_tokens(cfg, tokens)
    logits, aux = forward(cfg, params, inputs)
    return next_token_loss(logits, targets) + cfg.aux_coef * aux


__all__ = [
    "EXPERT_AXIS",
    "MoEConfig",
    "forward",
    "init_params",
    "loss_fn",
    "moe_layer",
    "param_sharding_rules",
    "params_from_jax",
    "tiny_moe_config",
]

"""Small convolutional classifier: the vision model family.

The port of ``torchft_tpu/models/cnn.py`` (the reference demo's CIFAR-10
family: conv blocks, global average pool, two dense layers). The master
tree keeps the JAX package's layouts, HWIO kernels and (in, out) dense
weights, so :func:`params_from_jax` is the identity on shapes and both
packages flatten the tree into the same leaves for the comm plan;
images arrive NHWC as there. The convolutions run through ``F.conv2d``
(the JAX package computes them in XLA, outside any Pallas kernel) on an
NCHW view, kernels permuted to OIHW at use. Activations in ``cfg.dtype``
(bf16) over f32 masters; GroupNorm in f32 with the population variance
and eps 1e-5, then cast back: no batch statistics, so replica groups'
batches stay independent. Every leaf is replicated
(:func:`param_sharding_rules`); the batch splits over ``data``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from .._tree import flatten, tree_map, unflatten

Params = Dict[str, Any]


@dataclass(frozen=True)
class CNNConfig:
    image_size: int = 32
    channels: int = 3
    classes: int = 10
    widths: Tuple[int, ...] = (64, 128, 256)  # one conv block per entry
    groups: int = 8          # GroupNorm groups
    dense_width: int = 256
    dtype: torch.dtype = torch.bfloat16


def tiny_cnn_config() -> CNNConfig:
    return CNNConfig(image_size=16, widths=(8, 16), groups=4, dense_width=32)


def init_shapes(cfg: CNNConfig) -> Dict[str, Any]:
    """Leaf-shape skeleton (tuples) matching :func:`init_params`."""
    c_in = cfg.channels
    blocks = []
    for c_out in cfg.widths:
        blocks.append({"kernel": (3, 3, c_in, c_out),
                       "gn": {"scale": (c_out,), "bias": (c_out,)}})
        c_in = c_out
    return {
        "blocks": blocks,
        "dense": {"w": (c_in, cfg.dense_width), "b": (cfg.dense_width,)},
        "head": {"w": (cfg.dense_width, cfg.classes), "b": (cfg.classes,)},
    }


def init_params(
    cfg: CNNConfig,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> Params:
    """f32 master parameters with the JAX package's scales (He-normal
    kernels, ``fan_in ** -0.5`` dense layers), drawn from a seeded
    ``torch.Generator``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)

    def normal(shape: Tuple[int, ...], scale: float) -> torch.Tensor:
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    blocks = []
    c_in = cfg.channels
    for c_out in cfg.widths:
        blocks.append({
            "kernel": normal((3, 3, c_in, c_out), (2.0 / (9 * c_in)) ** 0.5),
            "gn": {"scale": torch.ones(c_out, device=dev),
                   "bias": torch.zeros(c_out, device=dev)},
        })
        c_in = c_out
    return {
        "blocks": blocks,
        "dense": {"w": normal((c_in, cfg.dense_width), c_in ** -0.5),
                  "b": torch.zeros(cfg.dense_width, device=dev)},
        "head": {"w": normal((cfg.dense_width, cfg.classes),
                             cfg.dense_width ** -0.5),
                 "b": torch.zeros(cfg.classes, device=dev)},
    }


def param_sharding_rules(cfg: CNNConfig) -> Dict[str, Any]:
    """All replicated (data parallel only): ``()`` per leaf."""
    return _replicated(init_shapes(cfg))


def _replicated(shapes: Any) -> Any:
    if isinstance(shapes, dict):
        return {k: _replicated(v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_replicated(v) for v in shapes]
    return ()


def params_from_jax(
    tree: Any, device: Optional[Union[str, torch.device]] = None
) -> Params:
    """A JAX parameter tree (same layouts) as f32 torch tensors."""
    dev = resolve_device(device)
    return tree_map(
        lambda l: torch.tensor(np.asarray(l, dtype=np.float32), device=dev),
        tree)


def _group_norm(x: torch.Tensor, p: Params, groups: int) -> torch.Tensor:
    """GroupNorm of NCHW activations in f32 (population variance)."""
    B, C, H, W = x.shape
    x32 = x.float().reshape(B, groups, C // groups, H, W)
    mean = x32.mean(dim=(2, 3, 4), keepdim=True)
    var = x32.var(dim=(2, 3, 4), keepdim=True, unbiased=False)
    x32 = ((x32 - mean) * torch.rsqrt(var + 1e-5)).reshape(B, C, H, W)
    return (x32 * p["scale"][:, None, None]
            + p["bias"][:, None, None]).to(x.dtype)


def forward(cfg: CNNConfig, params: Params, images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, C) -> logits (B, classes) f32."""
    x = images.to(cfg.dtype).permute(0, 3, 1, 2)  # NCHW view
    for block in params["blocks"]:
        w = block["kernel"].to(cfg.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
        x = F.conv2d(x, w, padding=1)  # 3x3, stride 1, SAME
        x = F.relu(_group_norm(x, block["gn"], cfg.groups))
        x = F.max_pool2d(x, 2, 2)  # 2x2 VALID
    x = x.mean(dim=(2, 3))  # global average pool -> (B, C)
    x = F.relu(x @ params["dense"]["w"].to(cfg.dtype)
               + params["dense"]["b"].to(cfg.dtype))
    logits = (x @ params["head"]["w"].to(cfg.dtype)
              + params["head"]["b"].to(cfg.dtype))
    return logits.float()


def loss_fn(cfg: CNNConfig, params: Params,
            batch: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Cross entropy over (images (B, H, W, C), labels (B,) int)."""
    images, labels = batch
    logp = torch.log_softmax(forward(cfg, params, images), dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels[:, None].long()))


class CNN(nn.Module):
    """The classifier as an ``nn.Module`` whose parameters ARE the tree
    :meth:`params` returns (so an ``FTTrainState`` over it updates the
    module in place)."""

    def __init__(self, cfg: CNNConfig, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        super().__init__()
        self.cfg = cfg
        leaves, self._treedef = flatten(init_params(cfg, seed, device))
        self.leaves = nn.ParameterList([nn.Parameter(l) for l in leaves])

    def params(self) -> Params:
        return unflatten(self._treedef, list(self.leaves))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return forward(self.cfg, self.params(), images)

    def loss(self, batch: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        return loss_fn(self.cfg, self.params(), batch)


__all__: List[str] = [
    "CNN",
    "CNNConfig",
    "forward",
    "init_params",
    "init_shapes",
    "loss_fn",
    "param_sharding_rules",
    "params_from_jax",
    "tiny_cnn_config",
]

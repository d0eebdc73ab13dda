"""Models of the port: the transformer LM (dense and flash attention,
tensor and context parallel), the MoE family and the CNN."""

from . import cnn, moe
from .cnn import CNNConfig, tiny_cnn_config
from .moe import MoEConfig, tiny_moe_config
from .transformer import (
    TransformerConfig,
    TransformerLM,
    forward,
    init_params,
    loss_fn,
    make_grad_fn,
    make_train_step,
    param_count,
    param_sharding_rules,
    params_from_jax,
    tiny_config,
)

__all__ = [
    "CNNConfig",
    "MoEConfig",
    "TransformerConfig",
    "TransformerLM",
    "cnn",
    "forward",
    "init_params",
    "loss_fn",
    "make_grad_fn",
    "make_train_step",
    "moe",
    "param_count",
    "param_sharding_rules",
    "params_from_jax",
    "tiny_cnn_config",
    "tiny_config",
    "tiny_moe_config",
]

"""Models of the port (the transformer LM's dense path)."""

from .transformer import (
    TransformerConfig,
    TransformerLM,
    forward,
    init_params,
    loss_fn,
    make_grad_fn,
    make_train_step,
    param_count,
    params_from_jax,
    tiny_config,
)

__all__ = [
    "TransformerConfig",
    "TransformerLM",
    "forward",
    "init_params",
    "loss_fn",
    "make_grad_fn",
    "make_train_step",
    "param_count",
    "params_from_jax",
    "tiny_config",
]

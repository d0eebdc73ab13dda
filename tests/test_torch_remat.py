"""Remat on the port's transformer LM: ``remat=True`` (each block
recomputed in the backward through ``torch.utils.checkpoint``,
non-reentrant) and ``remat_policy="save_attn"`` (the attention output and
the flash operator's ``out``/``lse`` kept, so the replay skips the
forward kernel), against the JAX package's LM with the same settings
(its flash path through the Pallas kernels in interpret mode).

- Config validation: the JAX package's rule and message.
- Port against JAX, f32, dense and flash, remat off / full / save_attn:
  the loss and every gradient to rtol 1e-5 / atol 1e-5 (summation order,
  as tests/test_torch_transformer.py states).
- The port's remat gradients bit-identical to its own no-remat ones: the
  replay runs the same operations on the same inputs.
- Forward-kernel calls per step on the plain path: ``n_layers`` without
  remat, ``2 * n_layers`` under full remat, ``n_layers`` under
  ``save_attn``.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

from conftest import HAS_SHARD_MAP, SHARD_MAP_SKIP

if not HAS_SHARD_MAP:
    # the JAX flash kernel's module imports jax.shard_map at load
    pytest.skip(SHARD_MAP_SKIP, allow_module_level=True)

import test_torch_transformer as base
from torchft_tpu.models import transformer as jt
from torchft_tpu_torch.models import transformer as tt

tfa = importlib.import_module("torchft_tpu_torch.ops.flash_attention")

REMAT = {"off": dict(remat=False), "full": dict(remat=True),
         "save_attn": dict(remat=True, remat_policy="save_attn")}
ATTN = {"dense": dict(use_flash=False), "flash": dict(use_flash=True)}
N_LAYERS = 2  # tiny_config


def _setup(attn, remat):
    jcfg, tcfg, jparams, tparams, tokens = base._setup("f32", seed=2)
    extra = {**ATTN[attn], **REMAT[remat]}
    return (dataclasses.replace(jcfg, **extra),
            dataclasses.replace(tcfg, **extra), jparams, tparams, tokens)


@pytest.mark.parametrize("policy", ["save_all", "", "dots"])
def test_unknown_policy_is_refused_as_in_jax(policy):
    with pytest.raises(ValueError) as jerr:
        jt.TransformerConfig(remat=True, remat_policy=policy)
    with pytest.raises(ValueError) as terr:
        tt.TransformerConfig(remat=True, remat_policy=policy)
    assert str(terr.value) == str(jerr.value)


def test_defaults_match_jax():
    j, t = jt.TransformerConfig(), tt.TransformerConfig()
    assert (t.remat, t.remat_policy) == (j.remat, j.remat_policy) == (False, None)
    # a policy without remat is accepted by both and changes nothing
    jt.TransformerConfig(remat_policy="save_attn")
    tt.TransformerConfig(remat_policy="save_attn")


@pytest.mark.parametrize("remat", sorted(REMAT))
@pytest.mark.parametrize("attn", sorted(ATTN))
def test_loss_and_every_gradient_match_jax(attn, remat):
    jcfg, tcfg, jparams, tparams, tokens = _setup(attn, remat)
    jloss, jgrads = base._jax_value_and_grad(jcfg, jparams, tokens)
    tloss, tgrads = base._torch_value_and_grad(tcfg, tparams, tokens)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5, atol=1e-5)
    assert len(tgrads) == len(jgrads) == 3 + 6 * N_LAYERS
    for t, j in zip(tgrads, jgrads):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("remat", ["full", "save_attn"])
@pytest.mark.parametrize("attn", sorted(ATTN))
def test_remat_gradients_bit_identical_to_no_remat(attn, remat):
    _, ocfg, _, tparams, tokens = _setup(attn, "off")
    _, rcfg, _, _, _ = _setup(attn, remat)
    oloss, ograds = base._torch_value_and_grad(ocfg, tparams, tokens)
    rloss, rgrads = base._torch_value_and_grad(rcfg, tparams, tokens)
    assert rloss.tobytes() == oloss.tobytes()
    for r, o in zip(rgrads, ograds):
        assert r.tobytes() == o.tobytes()


@pytest.mark.parametrize("remat,per_layer",
                         [("off", 1), ("full", 2), ("save_attn", 1)])
def test_forward_kernel_calls_per_step(monkeypatch, remat, per_layer):
    _, tcfg, _, tparams, tokens = _setup("flash", remat)
    calls = []
    plain = tfa.flash_fwd

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(tfa, "flash_fwd", counted)
    base._torch_value_and_grad(tcfg, tparams, tokens)
    assert len(calls) == per_layer * N_LAYERS


def test_save_attn_keeps_only_the_named_outputs():
    """The policy saves the flash operator (both outputs) and the
    ``attn_out`` name, and recomputes every other operation."""
    policy_ctx = tfa.save_only_these_names("attn_out", "flash_out", "flash_lse")
    fwd_ctx, _ = policy_ctx()
    policy = fwd_ctx.policy_fn
    from torch.utils.checkpoint import CheckpointPolicy

    flash = torch.ops.torchft_tpu_torch.flash_fwd.default
    named = torch.ops.torchft_tpu_torch.checkpoint_name.default
    assert policy(None, flash) == CheckpointPolicy.MUST_SAVE
    assert policy(None, named, torch.ones(1), "attn_out") == CheckpointPolicy.MUST_SAVE
    assert policy(None, named, torch.ones(1), "other") == CheckpointPolicy.PREFER_RECOMPUTE
    assert policy(None, torch.ops.aten.mm.default) == CheckpointPolicy.PREFER_RECOMPUTE
    only_attn = tfa.save_only_these_names("attn_out")()[0].policy_fn
    assert only_attn(None, flash) == CheckpointPolicy.PREFER_RECOMPUTE


def test_checkpoint_name_is_the_identity_with_its_gradient():
    x = torch.randn(3, 4, requires_grad=True)
    y = tfa.checkpoint_name(x, "attn_out")
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    (y * 3).sum().backward()
    assert torch.equal(x.grad, torch.full((3, 4), 3.0))

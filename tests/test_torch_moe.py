"""The port's MoE family (``torchft_tpu_torch.models.moe``) against the
JAX package's on the same weights (``params_from_jax``) and tokens.

- f32 configs at rtol 1e-5 / atol 1e-6: the layer's output and aux and
  the losses; the model's logits and every gradient at atol 1e-5 (the
  port's f32 LM contract, ``tests/test_torch_transformer.py``: summation
  order alone parts them by up to 2e-6 on logits of size 3); the bf16
  default's loss within 3e-3 (the JAX package's own
  sharded-against-unsharded bound).
- One expert of capacity "all" is the dense MLP; a capacity of one slot
  drops what the JAX layer drops, row for row.
- Expert parallelism at ``{"data": 2, "expert": 2}`` (threads over gloo)
  against the unsharded JAX model at capacity factor 0.5 (half the
  claims cannot fit): the capacity counts the global batch and each
  data rank's slots start after the lower ranks' claims, or the two
  would drop different tokens. Also with a ``model`` axis, without an
  ``expert`` axis, and with the sequence split too.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp

from torchft_tpu.models import moe as jmoe
from torchft_tpu_torch import parallel as par
from torchft_tpu_torch._tree import flatten, unflatten
from torchft_tpu_torch.models import moe as tmoe

RTOL, ATOL = 1e-5, 1e-6
# whole-model logits and gradients: the repository's f32 LM contract
# (tests/test_torch_transformer.py), the sides differing only in
# summation order
MODEL_ATOL = 1e-5
BF16_TOL = 3e-3
KW = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
          max_seq_len=128, n_experts=4, router_k=2)


def _cfgs(dtype="f32", **kw):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (jmoe.MoEConfig(**{**KW, **kw}, dtype=jdt),
            tmoe.MoEConfig(**{**KW, **kw}, dtype=tdt))


def _params(jcfg, seed=0):
    jparams = jmoe.init_params(jcfg, jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, np_params, tmoe.params_from_jax(np_params, device="cpu")


def _tokens(batch=4, seq=33, seed=0):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (batch, seq)).astype(np.int32)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_layer_output_and_aux_match_jax(capacity_factor):
    jcfg, tcfg = _cfgs(capacity_factor=capacity_factor, moe_every_block=True,
                       n_layers=1)
    jparams, _, tparams = _params(jcfg)
    x = np.random.default_rng(1).standard_normal((2, 16, 64)).astype(np.float32)
    jout, jaux = jmoe.moe_layer(jcfg, jparams["blocks"][0]["moe"], jnp.asarray(x))
    tout, taux = tmoe.moe_layer(tcfg, tparams["blocks"][0]["moe"], torch.tensor(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL, atol=ATOL)


def test_forward_loss_and_gradients_match_jax_f32():
    jcfg, tcfg = _cfgs()
    jparams, np_params, tparams = _params(jcfg)
    tokens = _tokens()
    jlogits, jaux = jmoe.forward(jcfg, jparams, jnp.asarray(tokens[:, :-1]))
    tlogits, taux = tmoe.forward(tcfg, tparams, torch.tensor(tokens[:, :-1]))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=RTOL,
                               atol=MODEL_ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL, atol=ATOL)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmoe.loss_fn(jcfg, p, jnp.asarray(tokens)))(jparams)
    leaves, treedef = flatten(tparams)
    work = [l.clone().requires_grad_(True) for l in leaves]
    tloss = tmoe.loss_fn(tcfg, unflatten(treedef, work), torch.tensor(tokens))
    grads = torch.autograd.grad(tloss, work)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=RTOL,
                               atol=ATOL)
    for g, r in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=MODEL_ATOL)


def test_bf16_loss_within_tolerance():
    jcfg, tcfg = _cfgs("bf16")
    jparams, _, tparams = _params(jcfg, seed=2)
    tokens = _tokens(seed=2)
    np.testing.assert_allclose(
        float(tmoe.loss_fn(tcfg, tparams, torch.tensor(tokens))),
        float(jmoe.loss_fn(jcfg, jparams, jnp.asarray(tokens))), rtol=BF16_TOL)


def test_single_expert_equals_the_dense_mlp():
    _, tcfg = _cfgs(n_experts=1, router_k=1, capacity_factor=1e9,
                    moe_every_block=True, n_layers=1)
    tparams = tmoe.init_params(tcfg, 0, "cpu")
    p = tparams["blocks"][0]["moe"]
    x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(1))
    out, _ = tmoe.moe_layer(tcfg, p, x)
    ref = torch.nn.functional.gelu(x @ p["wi"][0], approximate="tanh") @ p["wo"][0]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=RTOL, atol=1e-5)


def test_capacity_drops_what_jax_drops():
    jcfg, tcfg = _cfgs(capacity_factor=1e-9, moe_every_block=True, n_layers=1)
    jparams, _, tparams = _params(jcfg)
    x = np.random.default_rng(3).standard_normal((1, 32, 64)).astype(np.float32)
    jout, _ = jmoe.moe_layer(jcfg, jparams["blocks"][0]["moe"], jnp.asarray(x))
    tout, _ = tmoe.moe_layer(tcfg, tparams["blocks"][0]["moe"], torch.tensor(x))
    zero = (tout.abs().sum(-1) == 0).numpy()[0]
    np.testing.assert_array_equal(zero, (np.abs(np.asarray(jout)).sum(-1) == 0)[0])
    assert zero.sum() >= 32 - 2 * KW["n_experts"]


@pytest.mark.parametrize("axes,extra", [
    ({"data": 2, "expert": 2}, {}),
    ({"data": 2, "expert": 2, "model": 2}, {}),
    ({"data": 2, "model": 2}, {}),
    ({"data": 2, "seq": 2}, {"cp_seq_axis": "seq"}),
])
def test_sharded_matches_unsharded_jax(axes, extra):
    # capacity 0.5: over a quarter of the claims are dropped, so a slot
    # count that ignored the lower ranks' claims would drop others
    jcfg, tcfg = _cfgs(capacity_factor=0.5)
    jparams, np_params, whole = _params(jcfg, seed=4)
    tokens = _tokens(seed=4)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmoe.loss_fn(jcfg, p, jnp.asarray(tokens)))(jparams)
    _, treedef = flatten(whole)
    ref = unflatten(treedef, [torch.tensor(np.asarray(g))
                              for g in jax.tree_util.tree_leaves(jgrads)])

    def fn(mesh):
        cfg = dataclasses.replace(tcfg, cp_mesh=mesh, **extra)
        rules = par.restrict_rules(tmoe.param_sharding_rules(cfg), mesh)
        step = par.build_grad_step(lambda p, b: tmoe.loss_fn(cfg, p, b), mesh,
                                   rules)
        loss, grads = step(par.shard_pytree(whole, rules, mesh),
                           torch.tensor(tokens))
        return float(loss), flatten(grads)[0], flatten(
            par.shard_pytree(ref, rules, mesh))[0]

    for loss, grads, blocks in par.run_thread_mesh(axes, fn):
        np.testing.assert_allclose(loss, float(jloss), rtol=RTOL, atol=ATOL)
        for g, r in zip(grads, blocks):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=RTOL,
                                       atol=MODEL_ATOL)


def test_capacity_half_drops_claims():
    tcfg = _cfgs(capacity_factor=0.5)[1]
    assert tcfg.capacity(4 * 32) == 32  # 256 claims over 4 experts x 32 slots
    assert tcfg.capacity(10) == 2 and tcfg.capacity(1) == 1


def test_ep_bf16_loss_within_tolerance_of_unsharded_jax():
    jcfg, tcfg = _cfgs("bf16")
    jparams, _, whole = _params(jcfg, seed=5)
    tokens = _tokens(seed=5)
    jloss = float(jmoe.loss_fn(jcfg, jparams, jnp.asarray(tokens)))

    def fn(mesh):
        cfg = dataclasses.replace(tcfg, cp_mesh=mesh)
        rules = par.restrict_rules(tmoe.param_sharding_rules(cfg), mesh)
        step = par.build_grad_step(lambda p, b: tmoe.loss_fn(cfg, p, b), mesh,
                                   rules)
        return float(step(par.shard_pytree(whole, rules, mesh),
                          torch.tensor(tokens))[0])

    for loss in par.run_thread_mesh({"data": 2, "expert": 2}, fn):
        np.testing.assert_allclose(loss, jloss, rtol=BF16_TOL)


def test_params_from_jax_keeps_the_tree():
    jcfg, tcfg = _cfgs()
    jparams, np_params, tparams = _params(jcfg)
    port_init = tmoe.init_params(tcfg, 0, "cpu")
    jl = jax.tree_util.tree_leaves(np_params)
    tl, treedef = flatten(tparams)
    assert treedef == flatten(port_init)[1]
    assert [tuple(l.shape) for l in flatten(port_init)[0]] == [l.shape for l in jl]
    for a, b in zip(tl, jl):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)

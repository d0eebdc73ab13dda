"""The port's GPipe pipeline (``torchft_tpu_torch.pipeline``) against the
JAX package's ``pipeline_blocks`` on the same seeded blocks and inputs.

Each stage is a thread holding its block of the stacked layers
(``stage_specs``); every stage must return the JAX output, and the
gradients of every stage's layers and of the input must equal the JAX
package's (its transposed tick loop) in f32 at (stages, microbatches) in
(2, 2), (4, 2), (4, 4), alone and beside a ``data`` axis. The gradient
step over a pipelined transformer gives the JAX loss and gradients. The
divisibility rejections hold. Outputs compare at rtol 1e-5 / atol
1e-6; gradients, which sum a product per microbatch in another order
than the JAX transpose, at the JAX package's own pipeline tolerance
(rtol 1e-5 / atol 1e-5, ``tests/test_pipeline.py``).
"""

import functools

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp

from conftest import HAS_SHARD_MAP, SHARD_MAP_SKIP

if not HAS_SHARD_MAP:
    pytest.skip(SHARD_MAP_SKIP, allow_module_level=True)

from torchft_tpu import parallel as jpar
from torchft_tpu import pipeline as jpp
from torchft_tpu.models import transformer as jt
from torchft_tpu_torch import parallel as par
from torchft_tpu_torch import pipeline as tpp
from torchft_tpu_torch._tree import flatten, tree_map, unflatten
from torchft_tpu_torch.models import transformer as tt

RTOL, ATOL = 1e-5, 1e-6
# gradients sum one product per microbatch, in another order than the
# JAX tick loop's transpose: the JAX package's own pipeline tolerance
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5


def _blocks(n_layers, d, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((d, d)) * d ** -0.5).astype(np.float32),
             "b": (rng.standard_normal(d) * 0.1).astype(np.float32)}
            for _ in range(n_layers)]


def _jblock(p, x):
    return x + jnp.tanh(x @ p["w"] + p["b"])


def _tblock(p, x):
    return x + torch.tanh(x @ p["w"] + p["b"])


def _port_pipeline(blocks, x, w, axes, microbatches, data_axis=None):
    """Every rank's (output, d_input, d_stage_params) of sum(out * w)."""
    stacked = tpp.stack_blocks([tree_map(torch.tensor, b) for b in blocks])
    specs = tpp.stage_specs(stacked)

    def fn(mesh):
        stage = par.shard_pytree(stacked, specs, mesh)
        leaves, treedef = flatten(stage)
        work = [l.requires_grad_(True) for l in leaves]
        xb = torch.tensor(x)
        wb = torch.tensor(w)
        if data_axis is not None:
            xb = par.block_of(xb, (data_axis,), mesh)
            wb = par.block_of(wb, (data_axis,), mesh)
        xb = xb.clone().requires_grad_(True)
        out = tpp.pipeline_blocks(_tblock, unflatten(treedef, work), xb,
                                  mesh=mesh, microbatches=microbatches,
                                  data_axis=data_axis)
        # every stage computes the same loss: seed each with 1/stages
        loss = (out * wb).sum() / mesh.axis_size("pipe")
        grads = torch.autograd.grad(loss, [xb] + work)
        # the input's cotangent lives on stage 0 alone: sum it over pipe
        dx = par._raw_all_reduce(grads[0], mesh, "pipe")
        return out.detach().numpy(), dx.numpy(), [g.numpy() for g in grads[1:]]

    return par.run_thread_mesh(axes, fn)


def _jax_pipeline(blocks, x, w, axes, microbatches, data_axis=None):
    jmesh = jpar.make_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
    stacked = jpp.stack_blocks([jax.tree_util.tree_map(jnp.asarray, b)
                                for b in blocks])

    def f(stacked, x):
        return jpp.pipeline_blocks(_jblock, stacked, x, mesh=jmesh,
                                   microbatches=microbatches,
                                   data_axis=data_axis)

    out = f(stacked, jnp.asarray(x))
    dstacked, dx = jax.grad(lambda s, x: jnp.sum(f(s, x) * w),
                            argnums=(0, 1))(stacked, jnp.asarray(x))
    return np.asarray(out), np.asarray(dx), dstacked


@pytest.mark.parametrize("n_stages,microbatches", [(2, 2), (4, 2), (4, 4)])
def test_outputs_and_grads_match_the_jax_pipeline(n_stages, microbatches):
    d, n_layers = 8, 8
    blocks = _blocks(n_layers, d)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, d)).astype(np.float32)
    w = rng.standard_normal((8, d)).astype(np.float32)
    axes = {"pipe": n_stages}
    ref_out, ref_dx, ref_ds = _jax_pipeline(blocks, x, w, axes, microbatches)
    res = _port_pipeline(blocks, x, w, axes, microbatches)
    per = n_layers // n_stages
    ref_leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(ref_ds)]
    for stage, (out, dx, dstage) in enumerate(res):
        np.testing.assert_allclose(out, ref_out, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(dx, ref_dx, rtol=GRAD_RTOL, atol=GRAD_ATOL)
        for g, r in zip(dstage, ref_leaves):
            np.testing.assert_allclose(g, r[stage * per:(stage + 1) * per],
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_dp_x_pipe_matches_the_jax_pipeline():
    d, n_layers = 8, 4
    blocks = _blocks(n_layers, d, seed=2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, d)).astype(np.float32)
    w = rng.standard_normal((8, d)).astype(np.float32)
    axes = {"data": 2, "pipe": 4}
    ref_out, _, _ = _jax_pipeline(blocks, x, w, axes, 2, data_axis="data")
    res = _port_pipeline(blocks, x, w, axes, 2, data_axis="data")
    for rank, (out, _, _) in enumerate(res):
        mesh = par.Mesh(axes, rank, {}, "gloo")
        np.testing.assert_allclose(
            out, par.block_of(torch.tensor(ref_out), ("data",), mesh).numpy(),
            rtol=RTOL, atol=ATOL)


def test_one_stage_is_the_sequential_stack():
    blocks = _blocks(3, 8, seed=4)
    x = np.random.default_rng(5).standard_normal((4, 8)).astype(np.float32)
    stacked = tpp.stack_blocks([tree_map(torch.tensor, b) for b in blocks])
    out = par.run_thread_mesh(
        {"pipe": 1}, lambda m: tpp.pipeline_blocks(
            _tblock, stacked, torch.tensor(x), mesh=m, microbatches=2))[0]
    ref = torch.tensor(x)
    for b in blocks:
        ref = _tblock(tree_map(torch.tensor, b), ref)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)


def test_bad_divisibility_raises():
    stacked = tpp.stack_blocks([tree_map(torch.tensor, b)
                                for b in _blocks(3, 8)])
    mesh = par.Mesh({"pipe": 2}, 0, {}, "gloo")
    with pytest.raises(ValueError, match="divisible"):
        par.shard_pytree(stacked, tpp.stage_specs(stacked), mesh)
    with pytest.raises(ValueError, match="microbatches"):
        tpp.pipeline_blocks(_tblock, stacked, torch.ones(3, 8), mesh=mesh,
                            microbatches=2)
    # the split happens on the per-shard batch: a rank's 4 rows do not
    # split into 8 microbatches
    mesh_dp = par.Mesh({"data": 2, "pipe": 4}, 0, {}, "gloo")
    with pytest.raises(ValueError, match="per-shard"):
        tpp.pipeline_blocks(_tblock, stacked, torch.ones(4, 8), mesh=mesh_dp,
                            microbatches=8, data_axis="data")


def test_pipelined_transformer_grad_step_matches_jax():
    kw = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=4, d_ff=128,
              max_seq_len=128)
    jcfg = jt.TransformerConfig(**kw, dtype=jnp.float32)
    tcfg = tt.TransformerConfig(**kw, dtype=torch.float32)
    raw = jt.init_params(jcfg, jax.random.PRNGKey(4))
    jparams = {"backbone": {k: v for k, v in raw.items() if k != "blocks"},
               "stacked": jpp.stack_blocks(raw["blocks"])}
    tokens = np.random.default_rng(6).integers(0, 256, (4, 33)).astype(np.int32)
    axes = {"data": 2, "pipe": 2}
    jmesh = jpar.make_mesh(axes, devices=jax.devices()[:4])

    def jloss(params, tokens):
        x = jt.embed_tokens(jcfg, params["backbone"], tokens[:, :-1])
        x = jpp.pipeline_blocks(functools.partial(jt._block, jcfg),
                                params["stacked"], x, mesh=jmesh,
                                microbatches=2, data_axis="data")
        return jt.next_token_loss(jt.readout(jcfg, params["backbone"], x),
                                  tokens[:, 1:])

    ref_loss, ref_grads = jax.value_and_grad(jloss)(jparams, jnp.asarray(tokens))
    whole = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    rules = {"backbone": tree_map(lambda l: (), whole["backbone"]),
             "stacked": tpp.stage_specs(whole["stacked"])}

    def fn(mesh):
        def loss_fn(params, tokens):
            x = tt.embed_tokens(tcfg, params["backbone"], tokens[:, :-1])
            x = tpp.pipeline_blocks(functools.partial(tt._block, tcfg),
                                    params["stacked"], x, mesh=mesh,
                                    microbatches=2, data_axis="data")
            return tt.next_token_loss(tt.readout(tcfg, params["backbone"], x),
                                      tokens[:, 1:])

        step = par.build_grad_step(loss_fn, mesh, rules)
        loss, grads = step(par.shard_pytree(whole, rules, mesh),
                           torch.tensor(tokens))
        return float(loss), grads

    _, treedef = flatten(whole)
    ref = unflatten(treedef, [torch.tensor(np.asarray(g)) for g in
                              jax.tree_util.tree_leaves(ref_grads)])
    for rank, (loss, grads) in enumerate(par.run_thread_mesh(axes, fn)):
        np.testing.assert_allclose(loss, float(ref_loss), rtol=RTOL, atol=ATOL)
        blocks = par.shard_pytree(ref, rules, par.Mesh(axes, rank, {}, "gloo"))
        for g, r in zip(flatten(grads)[0], flatten(blocks)[0]):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL)

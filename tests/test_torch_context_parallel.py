"""The port's context parallelism (``torchft_tpu_torch.context_parallel``)
against the JAX package's ``ring_attention`` and ``ulysses_attention``
on the same seeded inputs.

Each mesh rank is a thread holding its block of q, k and v (its data
rows, its sequence block and, over ``model``, its heads); the blocks of
the port's outputs, reassembled, must equal the JAX output on the whole
arrays (8 virtual CPU devices) at ``{"seq": 2}``, ``{"seq": 4}`` and
``{"data": 2, "seq": 2, "model": 2}``, causal and not, in f32 (rtol
1e-5 / atol 1e-6). Gradients go through the ring's ppermutes and the
Ulysses all-to-alls (their adjoints). The JAX rejections (sequence and
head divisibility, the config's checks) hold, and the transformer's
strategy switch gives the JAX package's loss.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp

from conftest import HAS_SHARD_MAP, SHARD_MAP_SKIP

if not HAS_SHARD_MAP:
    pytest.skip(SHARD_MAP_SKIP, allow_module_level=True)

from torchft_tpu import context_parallel as jcp
from torchft_tpu import parallel as jpar
from torchft_tpu.models import transformer as jt
from torchft_tpu_torch import context_parallel as tcp
from torchft_tpu_torch import parallel as par
from torchft_tpu_torch.models import transformer as tt

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5
MESHES = {
    "seq2": ({"seq": 2}, None, None),
    "seq4": ({"seq": 4}, None, None),
    "dp_seq_tp": ({"data": 2, "seq": 2, "model": 2}, "data", "model"),
}


def _qkv(B=4, S=32, H=4, D=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(3)]


def _block(x, mesh, batch_axis, head_axis):
    """This rank's (rows, sequence block, heads) block of a whole array."""
    x = torch.tensor(x)
    x = par.block_of(x, (batch_axis, "seq", head_axis), mesh)
    return x.contiguous()


def _assemble(blocks, axes, batch_axis, head_axis, shape):
    out = np.zeros(shape, np.float32)
    for rank, b in enumerate(blocks):
        mesh = par.Mesh(axes, rank, {}, "gloo")
        view = par.block_of(torch.from_numpy(out), (batch_axis, "seq",
                                                    head_axis), mesh)
        view.copy_(torch.tensor(b))
    return out


def _jax_fn(strategy):
    return jcp.ring_attention if strategy == "ring" else jcp.ulysses_attention


def _port_fn(strategy):
    return tcp.ring_attention if strategy == "ring" else tcp.ulysses_attention


def _kwargs(strategy, causal):
    kw = {"causal": causal}
    if strategy == "ulysses":
        kw["use_flash"] = False
    return kw


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("causal", [True, False])
def test_matches_the_jax_function(strategy, mesh_name, causal):
    axes, batch_axis, head_axis = MESHES[mesh_name]
    q, k, v = _qkv(seed=len(mesh_name))
    jmesh = jpar.make_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
    ref = _jax_fn(strategy)(q, k, v, mesh=jmesh, seq_axis="seq",
                            batch_axis=batch_axis, head_axis=head_axis,
                            **_kwargs(strategy, causal))

    def fn(mesh):
        blocks = [_block(t, mesh, batch_axis, head_axis) for t in (q, k, v)]
        out = _port_fn(strategy)(*blocks, mesh=mesh, seq_axis="seq",
                                 batch_axis=batch_axis, head_axis=head_axis,
                                 **_kwargs(strategy, causal))
        return out.numpy()

    out = _assemble(par.run_thread_mesh(axes, fn), axes, batch_axis,
                    head_axis, q.shape)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
@pytest.mark.parametrize("mesh_name", ["seq4", "dp_seq_tp"])
def test_gradients_match_the_jax_function(strategy, mesh_name):
    axes, batch_axis, head_axis = MESHES[mesh_name]
    q, k, v = _qkv(seed=5)
    w = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    jmesh = jpar.make_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])

    def jloss(qkv):
        out = _jax_fn(strategy)(*qkv, mesh=jmesh, seq_axis="seq",
                                batch_axis=batch_axis, head_axis=head_axis,
                                **_kwargs(strategy, True))
        return jnp.sum(out * w)

    jgrads = jax.grad(jloss)(tuple(jnp.asarray(t) for t in (q, k, v)))

    def fn(mesh):
        blocks = [_block(t, mesh, batch_axis, head_axis).requires_grad_(True)
                  for t in (q, k, v)]
        out = _port_fn(strategy)(*blocks, mesh=mesh, seq_axis="seq",
                                 batch_axis=batch_axis, head_axis=head_axis,
                                 **_kwargs(strategy, True))
        wb = _block(w, mesh, batch_axis, head_axis)
        return [g.numpy() for g in torch.autograd.grad((out * wb).sum(),
                                                       blocks)]

    res = par.run_thread_mesh(axes, fn)
    for i, jg in enumerate(jgrads):
        g = _assemble([r[i] for r in res], axes, batch_axis, head_axis,
                      q.shape)
        np.testing.assert_allclose(g, np.asarray(jg), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_ulysses_flash_matches_the_jax_kernel():
    axes = {"seq": 2}
    q, k, v = _qkv(B=2, S=32, H=4, D=8, seed=9)
    jmesh = jpar.make_mesh(axes, devices=jax.devices()[:2])
    ref = jcp.ulysses_attention(q, k, v, mesh=jmesh, batch_axis=None,
                                use_flash=True)

    def fn(mesh):
        blocks = [_block(t, mesh, None, None) for t in (q, k, v)]
        return tcp.ulysses_attention(*blocks, mesh=mesh, batch_axis=None,
                                     use_flash=True).numpy()

    out = _assemble(par.run_thread_mesh(axes, fn), axes, None, None, q.shape)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=2e-6)


def test_fully_masked_blocks_give_zero_gradient_not_nan():
    # seq 4: rank 0's queries see only its own block; the three blocks
    # the ring brings it are masked whole (m stays -inf there)
    q, k, v = _qkv(B=1, S=16, H=2, D=8, seed=7)

    def fn(mesh):
        blocks = [_block(t, mesh, None, None).requires_grad_(True)
                  for t in (q, k, v)]
        out = tcp.ring_attention(*blocks, mesh=mesh, batch_axis=None)
        return [g for g in torch.autograd.grad(out.sum(), blocks)]

    for grads in par.run_thread_mesh({"seq": 4}, fn):
        assert all(torch.isfinite(g).all() for g in grads)


def test_rejections_match_the_jax_package():
    mesh = par.Mesh({"seq": 4}, 0, {}, "gloo")
    with pytest.raises(ValueError, match="not divisible"):
        tcp.split_sequence(torch.zeros(2, 30, 4, 8), mesh)
    q = torch.zeros(1, 4, 2, 8)  # 2 local heads < seq:4
    with pytest.raises(ValueError, match="head count"):
        tcp.ulysses_attention(q, q, q, mesh=mesh, batch_axis=None)
    with pytest.raises(ValueError, match="cp_strategy"):
        tt.TransformerConfig(cp_strategy="tree")
    with pytest.raises(ValueError, match="attn_window"):
        tt.TransformerConfig(use_flash=True, attn_window=4, cp_seq_axis="seq",
                             cp_mesh=mesh)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_transformer_strategy_switch_matches_the_jax_loss(strategy):
    kw = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              max_seq_len=128)
    jmesh = jpar.make_mesh({"seq": 4}, devices=jax.devices()[:4])
    jcfg = jt.TransformerConfig(**kw, dtype=jnp.float32, cp_seq_axis="seq",
                                cp_mesh=jmesh, cp_batch_axis=None,
                                cp_strategy=strategy)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, 256, (2, 33)).astype(np.int32)
    jloss = float(jt.loss_fn(jcfg, jparams, jnp.asarray(tokens)))
    whole = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")

    def fn(mesh):
        cfg = tt.TransformerConfig(**kw, dtype=torch.float32, cp_seq_axis="seq",
                                   cp_mesh=mesh, cp_batch_axis=None,
                                   cp_strategy=strategy)
        step = par.build_grad_step(lambda p, b: tt.loss_fn(cfg, p, b), mesh,
                                   par.restrict_rules(
                                       tt.param_sharding_rules(cfg), mesh))
        loss, _ = step(whole, torch.tensor(tokens))
        return float(loss)

    for loss in par.run_thread_mesh({"seq": 4}, fn):
        np.testing.assert_allclose(loss, jloss, rtol=RTOL, atol=ATOL)

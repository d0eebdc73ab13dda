"""The port's CNN family (``torchft_tpu_torch.models.cnn``) against the
JAX package's on the same weights and images.

The master tree keeps the JAX layouts (HWIO kernels, (in, out) dense
weights), so ``params_from_jax`` carries a JAX tree across leaf for
leaf. In f32 the logits, loss and every gradient agree within rtol 1e-5
(atol 1e-6 on logits and loss; 1e-5 on gradients, the port's f32
model contract: summation order); the bf16 default's loss within 3e-3.
A data-sharded batch (threads over gloo, ``build_grad_step``) gives the
unsharded loss and gradients.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp

from torchft_tpu.models import cnn as jcnn
from torchft_tpu_torch import parallel as par
from torchft_tpu_torch._tree import flatten, unflatten
from torchft_tpu_torch.models import cnn as tcnn

RTOL, ATOL = 1e-5, 1e-6
GRAD_ATOL = 1e-5
BF16_TOL = 3e-3


def _cfgs(dtype="f32", **kw):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    base = dict(image_size=16, widths=(8, 16), groups=4, dense_width=32)
    return (jcnn.CNNConfig(**{**base, **kw}, dtype=jdt),
            tcnn.CNNConfig(**{**base, **kw}, dtype=tdt))


def _setup(dtype="f32", seed=0, n=8, **kw):
    jcfg, tcfg = _cfgs(dtype, **kw)
    jparams = jcnn.init_params(jcfg, jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (n, jcfg.image_size, jcfg.image_size, jcfg.channels)).astype(np.float32)
    labels = rng.integers(0, jcfg.classes, n).astype(np.int32)
    return (jcfg, tcfg, jparams, tcnn.params_from_jax(np_params, device="cpu"),
            images, labels)


@pytest.mark.parametrize("widths", [(8, 16), (8, 16, 32)])
def test_forward_matches_jax_f32(widths):
    jcfg, tcfg, jparams, tparams, images, _ = _setup(widths=widths)
    ref = jcnn.forward(jcfg, jparams, jnp.asarray(images))
    out = tcnn.forward(tcfg, tparams, torch.tensor(images))
    assert out.dtype == torch.float32 and out.shape == (8, jcfg.classes)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_loss_and_gradients_match_jax_f32():
    jcfg, tcfg, jparams, tparams, images, labels = _setup(seed=1)
    jloss, jgrads = jax.value_and_grad(lambda p: jcnn.loss_fn(
        jcfg, p, (jnp.asarray(images), jnp.asarray(labels))))(jparams)
    leaves, treedef = flatten(tparams)
    work = [l.clone().requires_grad_(True) for l in leaves]
    loss = tcnn.loss_fn(tcfg, unflatten(treedef, work),
                        (torch.tensor(images), torch.tensor(labels)))
    grads = torch.autograd.grad(loss, work)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL,
                               atol=ATOL)
    for g, r in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=GRAD_ATOL)


def test_bf16_loss_within_tolerance():
    jcfg, tcfg, jparams, tparams, images, labels = _setup("bf16", seed=2)
    jloss = float(jcnn.loss_fn(jcfg, jparams, (jnp.asarray(images),
                                               jnp.asarray(labels))))
    loss = float(tcnn.loss_fn(tcfg, tparams, (torch.tensor(images),
                                              torch.tensor(labels))))
    np.testing.assert_allclose(loss, jloss, rtol=BF16_TOL)


def test_the_hwio_tree_is_the_jax_tree():
    jcfg, tcfg = _cfgs()
    np_params = jax.tree_util.tree_map(
        np.asarray, jcnn.init_params(jcfg, jax.random.PRNGKey(0)))
    mine = tcnn.init_params(tcfg, 0, "cpu")
    leaves, treedef = flatten(mine)
    assert treedef == flatten(tcnn.params_from_jax(np_params, device="cpu"))[1]
    assert [tuple(l.shape) for l in leaves] == [
        l.shape for l in jax.tree_util.tree_leaves(np_params)]
    assert mine["blocks"][0]["kernel"].shape == (3, 3, 3, 8)  # HWIO
    shapes = tcnn.init_shapes(tcfg)
    assert shapes == jcnn.init_shapes(jcfg)
    # the module's parameters are the tree
    model = tcnn.CNN(tcfg, seed=0, device="cpu")
    assert all(a is b for a, b in zip(flatten(model.params())[0],
                                      model.parameters()))


@pytest.mark.parametrize("axes", [{"data": 2}, {"data": 4}])
def test_data_sharded_batch_equals_unsharded(axes):
    _, tcfg, _, tparams, images, labels = _setup(seed=3)
    leaves, treedef = flatten(tparams)
    work = [l.clone().requires_grad_(True) for l in leaves]
    batch = (torch.tensor(images), torch.tensor(labels))
    loss = tcnn.loss_fn(tcfg, unflatten(treedef, work), batch)
    ref = torch.autograd.grad(loss, work)
    rules = tcnn.param_sharding_rules(tcfg)

    def fn(mesh):
        step = par.build_grad_step(lambda p, b: tcnn.loss_fn(tcfg, p, b), mesh,
                                   rules)
        l, g = step(par.shard_pytree(tparams, rules, mesh), batch)
        return float(l), flatten(g)[0]

    for l, grads in par.run_thread_mesh(axes, fn):
        np.testing.assert_allclose(l, float(loss.detach()), rtol=RTOL, atol=ATOL)
        for g, r in zip(grads, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=RTOL,
                                       atol=GRAD_ATOL)


def test_loss_decreases_with_sgd():
    _, tcfg, _, tparams, images, labels = _setup(seed=4, n=16)
    from torchft_tpu_torch import SGD

    tx = SGD(0.05)
    state = tx.init(tparams)
    batch = (torch.tensor(images), torch.tensor(labels))
    leaves, treedef = flatten(tparams)
    first = None
    for _ in range(10):
        work = [l.detach().requires_grad_(True) for l in leaves]
        loss = tcnn.loss_fn(tcfg, unflatten(treedef, work), batch)
        grads = torch.autograd.grad(loss, work)
        tx.update_(unflatten(treedef, leaves), state, unflatten(treedef, list(grads)))
        first = float(loss) if first is None else first
    assert float(loss) < first

"""Training state for fault-tolerant torch loops: parameters plus an
optimizer with optax numerics (``adamw``, and ``sgd`` with optional
Nesterov momentum, the DiLoCo outer optimizer).

The JAX package needs :class:`FTTrainState` because its pytrees are
immutable: a heal applied through a callback could be shadowed by stale
``params`` bound earlier in the step. In torch, ``load_state_dict`` copies
into the very tensors the optimizer steps, so the property comes for free;
the holder keeps the JAX package's API (``state_dict``,
``load_state_dict``, ``apply_gradients``) so the Manager and the DDP
wrappers read the same in both packages. Updates happen in place, under
``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ._tree import flatten, tree_map


class AdamW:
    """``optax.adamw`` in torch: ``scale_by_adam`` then
    ``add_decayed_weights`` then ``scale_by_learning_rate``, i.e.

        mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  t += 1
        u  = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
        p  = p + (-lr) (u + weight_decay p)

    The decay joins the Adam direction BEFORE the learning rate scales
    it, as optax orders it (``torch.optim.AdamW`` instead shrinks the
    parameter first). ``weight_decay`` defaults to optax's 1e-4, not
    torch's 1e-2. The update is multi-tensor (``torch._foreach_*``): a
    handful of launches per step for any number of leaves.
    """

    def __init__(
        self,
        learning_rate: float,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 1e-4,
    ) -> None:
        self.lr = learning_rate
        self.b1 = b1
        self.b2 = b2
        self.eps = eps
        self.weight_decay = weight_decay

    def init(self, params: Any) -> Dict[str, Any]:
        return {
            "count": 0,
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
        }

    @torch.no_grad()
    def update_(self, params: Any, opt_state: Dict[str, Any], grads: Any) -> None:
        """One step, in place on ``params`` and ``opt_state``."""
        p, _ = flatten(params)
        g = [
            gi.to(pi.dtype) if gi.dtype != pi.dtype else gi
            for gi, pi in zip(flatten(grads)[0], p)
        ]
        mu, _ = flatten(opt_state["mu"])
        nu, _ = flatten(opt_state["nu"])
        b1, b2 = self.b1, self.b2
        g1 = torch._foreach_mul(g, 1 - b1)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g1)
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        count = int(opt_state["count"]) + 1
        opt_state["count"] = count
        # bias corrections in f32, as optax computes them
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        mu_hat = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu_hat, den)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(p, upd)


class SGD:
    """``optax.sgd`` in torch: ``trace(momentum, nesterov)`` (when
    ``momentum`` is given) then ``scale_by_learning_rate``, i.e.

        t' = g + momentum t;  u = g + momentum t' (nesterov) or t'
        p  = p + (-lr) u

    every product and sum rounded on its own, as optax computes them
    eagerly. Elementwise, so it runs as well on a 1-D shard (the sharded
    DiLoCo outer step) as on a tree; the state is
    ``{"trace": <tree of zeros>}`` with momentum, ``{}`` without. The
    update is multi-tensor (``torch._foreach_*``)."""

    def __init__(self, learning_rate: float, momentum: Optional[float] = None,
                 nesterov: bool = False) -> None:
        self.lr = learning_rate
        self.momentum = momentum
        self.nesterov = nesterov

    def init(self, params: Any) -> Dict[str, Any]:
        if self.momentum is None:
            return {}
        return {"trace": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update_(self, params: Any, opt_state: Dict[str, Any], grads: Any) -> None:
        """One step, in place on ``params`` and ``opt_state``."""
        p, _ = flatten(params)
        g = [
            gi.to(pi.dtype) if gi.dtype != pi.dtype else gi
            for gi, pi in zip(flatten(grads)[0], p)
        ]
        d = g
        if self.momentum is not None:
            t, _ = flatten(opt_state["trace"])
            new_t = torch._foreach_add(g, torch._foreach_mul(t, self.momentum))
            d = new_t
            if self.nesterov:
                d = torch._foreach_add(g, torch._foreach_mul(new_t,
                                                             self.momentum))
            torch._foreach_copy_(t, new_t)
        torch._foreach_add_(p, torch._foreach_mul(d, -self.lr))


class FTTrainState:
    """Holder for ``params`` (a tree of tensors, e.g. a model's
    parameters) + ``opt_state`` + the optimizer.

    Wire its ``state_dict``/``load_state_dict`` into the Manager so a heal
    lands in the same tensors the train loop reads::

        state = FTTrainState(model.params(), AdamW(1e-3, weight_decay=1e-4))
        manager = Manager(..., state_dict=state.state_dict,
                          load_state_dict=state.load_state_dict)
    """

    def __init__(self, params: Any, tx: AdamW, opt_state: Optional[Any] = None) -> None:
        """``opt_state=()`` allocates no optimizer state: the mode of
        ``ShardedDDP``, which keeps only its shard of it."""
        self.params = params
        self.tx = tx
        self.opt_state = opt_state if opt_state is not None else tx.init(params)

    def state_dict(self) -> Dict[str, Any]:
        """References to the live tensors: valid until the next update.
        Live recovery is safe because the Manager re-locks the checkpoint
        gate (waiting out in-flight transfers) before the optimizer runs."""
        return {"params": self.params, "opt_state": self.opt_state}

    @torch.no_grad()
    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        """Copies a (possibly host/numpy) state dict into the live tensors,
        in place, on their devices. Raises on a structure mismatch."""
        _copy_into(self.params, state_dict["params"])
        sd_opt = state_dict["opt_state"]
        if not self.opt_state:  # opt_state=() (or stateless): nothing held
            if flatten(sd_opt)[0]:
                raise ValueError("state dict carries optimizer state this "
                                 "state was built without")
            return
        _load_opt_state(self.opt_state, sd_opt)

    def snapshot(self) -> Dict[str, Any]:
        """A host copy of the whole state in fresh buffers: CPU tensors
        for tensor leaves, other leaves (the step count) as they are.
        Unlike :meth:`state_dict` it aliases nothing live, so later
        updates do not reach it."""
        return tree_map(
            lambda l: l.detach().to("cpu", copy=True)
            if isinstance(l, torch.Tensor) else l,
            {"params": self.params, "opt_state": self.opt_state})

    @torch.no_grad()
    def restore(self, snapshot: Dict[str, Any]) -> None:
        """Copies a :meth:`snapshot` back in place, onto the state's own
        devices (:meth:`load_state_dict`). The JAX package needs this
        round trip around a data-plane rebuild that orphans its arrays;
        a torch process group's rebuild orphans nothing, so here it is a
        plain host checkpoint."""
        self.load_state_dict(snapshot)

    @torch.no_grad()
    def warm(self, grads_like: Any) -> None:
        """Warm-up for a hot-spare standby: runs one optimizer update on
        copies of the state with zero gradients shaped like
        ``grads_like``, so the first real ``apply_gradients`` after a
        promotion finds the update's device code loaded and its
        allocator pools sized. Copies, because even a zero-gradient
        AdamW step moves params (weight decay, bias correction): the live
        state stays untouched. On the card the update runs there; the
        call returns once it has finished."""
        params = tree_map(torch.clone, self.params)
        opt_state = tree_map(
            lambda l: l.clone() if isinstance(l, torch.Tensor) else l,
            self.opt_state)
        zeros = tree_map(
            lambda g: torch.zeros_like(g) if isinstance(g, torch.Tensor)
            else g, grads_like)
        self.tx.update_(params, opt_state, zeros)
        devices = {l.device for l in flatten(params)[0]
                   if isinstance(l, torch.Tensor) and l.is_cuda}
        for dev in devices:
            torch.cuda.synchronize(dev)

    def apply_gradients(self, grads: Any) -> None:
        """One optimizer update, in place."""
        self.tx.update_(self.params, self.opt_state, grads)


def build_shard_apply_step(tx: AdamW) -> Callable[[Any, Any, Any], Tuple[Any, Any]]:
    """The shard-local optimizer step of per-step ZeRO: ``(param_shard,
    opt_shard, grad_shard) -> (new_param_shard, new_opt_shard)``, state
    and work scaling with the ~1/W shard, not the model. The param shard
    is updated in place (``ShardedDDP`` slices it afresh every step); the
    optimizer shard is written into fresh buffers, so the one a
    discarded step started from survives it."""

    def apply(param_shard: Any, opt_shard: Any, grad_shard: Any) -> Tuple[Any, Any]:
        new_opt = tree_map(
            lambda l: l.clone() if isinstance(l, torch.Tensor) else l,
            opt_shard)
        tx.update_(param_shard, new_opt, grad_shard)
        return param_shard, new_opt

    return apply


def _load_opt_state(dst: Dict[str, Any], src: Any) -> None:
    """Loads an optimizer state dict in place: tensor subtrees are copied
    into (:func:`_copy_into`), other entries (AdamW's step count) are
    replaced. Raises on a structure mismatch."""
    if not isinstance(src, dict) or set(src) != set(dst):
        raise ValueError("state dict structure does not match the live state")
    for k, v in dst.items():
        if isinstance(v, dict) and flatten(v)[0] and not all(
                isinstance(l, torch.Tensor) for l in flatten(v)[0]):
            _load_opt_state(v, src[k])
        elif isinstance(v, (int, float)):
            dst[k] = type(v)(src[k])
        else:
            _copy_into(v, src[k])


def _copy_into(dst_tree: Any, src_tree: Any) -> None:
    dst, dst_def = flatten(dst_tree)
    src, src_def = flatten(src_tree)
    if dst_def != src_def:
        raise ValueError("state dict structure does not match the live state")
    for d, s in zip(dst, src):
        if isinstance(s, np.ndarray):
            # unpickled arrays are read-only views of the received bytes
            s = np.require(s, requirements="W")
        s = torch.as_tensor(s)
        if tuple(s.shape) != tuple(d.shape) or s.dtype != d.dtype:
            raise ValueError(
                f"leaf mismatch: live {tuple(d.shape)} {d.dtype}, "
                f"incoming {tuple(s.shape)} {s.dtype}"
            )
        d.copy_(s)

"""The port's experiment scripts (``experiments/*_torch.py``) against the
JAX scripts they port, on the CPU at tiny widths.

- The mfu breakdown's variant models, ``step_no_attn`` (attention
  replaced by ``x @ wo``) and ``step_mean_loss`` (cross-entropy replaced
  by the mean logit), built on both sides as the scripts build them (the
  JAX side patches ``_attention_impl`` / ``next_token_loss`` of its
  transformer inside ``try/finally``, as ``experiments/mfu_breakdown.py``
  does; the port's script patches ``_attention`` / ``next_token_loss``),
  on weights carried by ``params_from_jax``, f32 compute on the flash
  path: loss and every gradient to rtol 1e-5 / atol 1e-5 (summation
  order; a leaf the variant does not read gets zeros on both sides), and
  the parameters after one train step with AdamW (optax.adamw on the JAX
  side) to atol 1e-5 (1% of the step's largest move, lr 1e-3).
- The shape ablation's three cross-entropy variants (take, mask, onehot)
  on the head-only model (n_layers 0), each against the JAX script's
  variant (``experiments/ablate_big_shape.py:131-157``, rebuilt here: the
  script defines it inside ``main``) and against the default loss: loss
  and gradients to rtol 1e-5 / atol 1e-5.
- The flash sweep's plain forward+backward (its "dense" row) against
  ``jax.grad`` of the JAX script's dense attention on the same inputs,
  f32: gradients to 1e-5 of their largest magnitude.
- The scripts' own runs at tiny widths on the CPU (rows, launch checks,
  the plain check biting, patches restored), the join repro (the late
  group commits a step in a quorum of three; no wall-clock bound), and
  ``verify_e2e_torch.sh`` with ``DEVICE=cpu`` (a SIGKILL, a restart and
  a live heal; under a minute here).
- Without a card and without ``--device cpu`` each script raises.
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp

import test_torch_transformer as base
from conftest import HAS_SHARD_MAP, SHARD_MAP_SKIP
from torchft_tpu.models import transformer as jt
from torchft_tpu_torch._tree import flatten
from torchft_tpu_torch.models import transformer as tt
from torchft_tpu_torch.train_state import AdamW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = ("mfu_breakdown_torch", "flash_sweep_torch",
               "ablate_big_shape_torch", "join_starvation_repro_torch")


sys.path.insert(0, os.path.join(REPO, "experiments"))
mfu = importlib.import_module("mfu_breakdown_torch")
sweep = importlib.import_module("flash_sweep_torch")
abl = importlib.import_module("ablate_big_shape_torch")
ct = mfu.ct
CPU = torch.device("cpu")


def _env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


# -- the mfu breakdown's variant models ----------------------------------------

# name -> (JAX module attribute, its patch as the JAX script writes it, the
# port's module attribute, the port script's patch)
VARIANTS = {
    "step_no_attn": ("_attention_impl",
                     lambda cfg, p, x: x @ p["wo"].astype(cfg.dtype),
                     "_attention", mfu.no_attention),
    "step_mean_loss": ("next_token_loss",
                       lambda logits, targets: jnp.mean(logits),
                       "next_token_loss", mfu.mean_logit_loss),
}


def _patched(module, attr, fn, run):
    real = getattr(module, attr)
    setattr(module, attr, fn)
    try:
        return run()
    finally:
        setattr(module, attr, real)


def _flash_f32(seed=1):
    if not HAS_SHARD_MAP:
        pytest.skip(SHARD_MAP_SKIP)
    import dataclasses

    jcfg, tcfg, jparams, tparams, tokens = base._setup("f32", seed=seed)
    return (dataclasses.replace(jcfg, use_flash=True),
            dataclasses.replace(tcfg, use_flash=True), jparams, tparams,
            tokens)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_loss_and_gradients_match_jax(variant):
    jattr, jfn, tattr, tfn = VARIANTS[variant]
    jcfg, tcfg, jparams, tparams, tokens = _flash_f32()
    jloss, jgrads = _patched(
        jt, jattr, jfn, lambda: base._jax_value_and_grad(jcfg, jparams, tokens))
    tloss, tgrads = _patched(
        tt, tattr, tfn, lambda: base._torch_value_and_grad(tcfg, tparams, tokens))
    assert jt.next_token_loss is not jfn and tt._attention is not mfu.no_attention
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5, atol=1e-5)
    assert len(tgrads) == len(jgrads) == 15
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-5, atol=1e-5)
    if variant == "step_no_attn":  # each layer's wqkv is not read
        unread = [i for i, g in enumerate(jgrads) if not np.asarray(g).any()]
        assert len(unread) == tcfg.n_layers
        assert all(not tgrads[i].any() for i in unread)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_train_step_matches_jax(variant):
    jattr, jfn, tattr, tfn = VARIANTS[variant]
    jcfg, tcfg, jparams, _, tokens = _flash_f32()
    np_params = jax.tree_util.tree_map(np.asarray, jparams)

    def jax_step():  # the JAX step donates its params: a copy of each
        tx = optax.adamw(1e-3)
        step = jt.make_train_step(jcfg, tx)
        params = jax.tree_util.tree_map(jnp.array, np_params)
        params, _, loss = step(params, tx.init(params), jnp.asarray(tokens))
        return np.asarray(loss), jax.tree_util.tree_leaves(params)

    def port_step():
        tx = AdamW(1e-3)
        params = tt.params_from_jax(np_params, device="cpu")
        step = tt.make_train_step(tcfg, tx)
        params, opt_state, loss = step(params, tx.init(params),
                                       torch.from_numpy(tokens))
        assert opt_state["count"] == 1
        return loss.numpy(), [p.numpy() for p in flatten(params)[0]]

    jloss, jparams1 = _patched(jt, jattr, jfn, jax_step)
    tloss, tparams1 = _patched(tt, tattr, tfn, port_step)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5, atol=1e-5)
    for t, j in zip(tparams1, jparams1):
        np.testing.assert_allclose(t, np.asarray(j), rtol=0, atol=1e-5)


# -- the shape ablation's cross-entropy variants ----------------------------------


def _jax_loss_variant(variant):
    """``experiments/ablate_big_shape.py``'s ``loss_v(variant)`` (defined
    inside its ``main``), as written there."""

    def nt_loss(logits, targets):
        if variant == "take":
            logp = jax.nn.log_softmax(logits, axis=-1)
            ll = jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
            return -jnp.mean(ll)
        if variant == "mask":
            logz = jax.scipy.special.logsumexp(logits, axis=-1)
            tgt = jax.lax.broadcasted_iota(
                jnp.int32, logits.shape, logits.ndim - 1
            ) == targets[..., None]
            picked = jnp.sum(jnp.where(tgt, logits, 0.0), axis=-1)
            return jnp.mean(logz - picked)
        if variant == "onehot":
            logz = jax.scipy.special.logsumexp(logits, axis=-1)
            oh = jax.nn.one_hot(targets, logits.shape[-1], dtype=logits.dtype)
            picked = jnp.einsum("bsv,bsv->bs", logits, oh)
            return jnp.mean(logz - picked)
        raise ValueError(variant)

    return nt_loss


@pytest.mark.parametrize("variant", abl.LOSS_VARIANTS)
def test_loss_variants_match_jax(variant):
    import dataclasses

    jcfg, tcfg, jparams, tparams, tokens = base._setup("f32", seed=2)
    jcfg = dataclasses.replace(jcfg, n_layers=0)
    tcfg = dataclasses.replace(tcfg, n_layers=0)
    jparams = {**jparams, "blocks": []}
    tparams = {**tparams, "blocks": []}
    jloss, jgrads = _patched(
        jt, "next_token_loss", _jax_loss_variant(variant),
        lambda: base._jax_value_and_grad(jcfg, jparams, tokens))
    tloss, tgrads = _patched(
        tt, "next_token_loss", abl.loss_variant(variant),
        lambda: base._torch_value_and_grad(tcfg, tparams, tokens))
    dloss, dgrads = base._torch_value_and_grad(tcfg, tparams, tokens)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tloss, dloss, rtol=1e-5, atol=1e-5)
    assert len(tgrads) == len(jgrads) == 3
    for t, j, d in zip(tgrads, jgrads, dgrads):
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(t, d, rtol=1e-5, atol=1e-5)


# -- the flash sweep's plain forward+backward -------------------------------------


@pytest.mark.parametrize("S", [64, 63])
def test_sweep_plain_fwdbwd_matches_jax_dense(S):
    B, H, D = 2, 4, 16
    n = B * S * H * D
    rng = np.random.default_rng(S)
    q, k, v = (rng.standard_normal((B, S, H, D), dtype=np.float32)
               for _ in range(3))

    def dense(q, k, v):  # experiments/flash_sweep.py:46-51
        scores = jnp.einsum("bqhd,bkhd->bhqk", q, k) * (D ** -0.5)
        causal = jnp.tril(jnp.ones((S, S), jnp.bool_))
        scores = jnp.where(causal, scores, jnp.finfo(scores.dtype).min)
        probs = jax.nn.softmax(scores.astype(jnp.float32), axis=-1).astype(q.dtype)
        return jnp.einsum("bhqk,bkhd->bqhd", probs, v)

    def loss(q, k, v):
        return jnp.sum(dense(q, k, v).astype(jnp.float32)) / n

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)

    tfa = ct.tfa
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    cfg = tfa.FlashConfig(True, None, *tfa.resolve_blocks(S, CPU, None, None))
    q_s = tq * D ** -0.5
    do = torch.full((B, S, H, D), 1.0 / n)
    out, lse = tfa.flash_fwd_plain(q_s, tk, tv, cfg)
    dq_s, dk, dv = tfa.flash_bwd_plain(q_s, tk, tv, do, lse,
                                       tfa.flash_delta_plain(out, do), cfg)
    got = (dq_s * D ** -0.5, dk, dv)  # dq through q_s = q * scale
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_sweep_rows_name_their_paths():
    rows = []
    for label, shape in sweep.ATTN_SHAPES["tiny"]:
        rows += sweep.attn_rows(label, shape, CPU, warm=1, iters=1,
                                log=lambda m: None)
    by = {r["row"]: r for r in rows}
    assert by["B2 S64 ours bq=64 bk=64"]["path"] == "fast"
    assert by["B2 S64 ours bq=64 bk=32"]["path"] == "general"
    assert by["B2 S63 ours bq=64 bk=64"]["path"] == "fast ragged"
    assert by["B2 S63 ours bq=64 bk=32"]["path"] == "general ragged"
    for r in rows:
        assert r["launches"] == {}  # the plain versions launch nothing
        if " ours " in r["row"]:
            assert set(r["check"]) == {"K4", "K5"}
            assert all(e == 0.0 for k in r["check"].values()
                       for e in k["err"].values())
    assert by["B2 S64 sdpa flash"]["ms"] > 0


# -- the scripts' own runs at tiny widths -----------------------------------------


def test_mfu_breakdown_runs_and_restores_its_patches():
    real = (tt._attention, tt.next_token_loss)
    res = mfu.run(CPU, "tiny", warm=1, iters=1, matmul_iters=1,
                  log=lambda m: None)
    assert (tt._attention, tt.next_token_loss) == real
    names = [r["row"] for r in res["rows"]]
    assert names == ["matmul 256^3", "step_full", "grad_only", "fwd_only",
                     "step_no_attn", "step_mean_loss", "attn_standalone"]
    rows = {r["row"]: r for r in res["rows"]}
    L = tt.tiny_config().n_layers
    # every K4/K5 call of each row, warm-up and timed, was held against
    # its plain version
    assert rows["step_full"]["check"]["K4"]["calls"] == 2 * L
    assert rows["step_full"]["check"]["K5"]["calls"] == 2 * L
    assert rows["fwd_only"]["check"].keys() == {"K4"}
    assert rows["step_no_attn"]["check"] == {}
    assert rows["attn_standalone"]["check"]["K5"]["calls"] == 2
    assert res["mfu"]["of_datasheet"] is None  # no card: no datasheet peak
    assert set(res["split"]) >= {"optimizer_ms", "attention_ms", "xent_ms"}


def test_plain_check_bites():
    tfa = ct.tfa
    real = tfa.flash_fwd

    def nudged(q, k, v, cfg):
        out, lse = real(q, k, v, cfg)
        return out * 1.1, lse

    q = torch.randn((2, 64, 4, 16), dtype=torch.bfloat16)
    tfa.flash_fwd = nudged
    try:
        check = ct.PlainCheck()
        with pytest.raises(ct.PlainMismatch, match="K4 off its plain version"):
            with check.active("nudged"):
                sweep.flash_attention(q, q, q)
        assert tfa.flash_fwd is nudged  # the check restored what it found
    finally:
        tfa.flash_fwd = real


def test_plain_check_holds_typical_rows():
    """A K4 off by 5% on the last three quarters of the rows, which a
    near-uniform causal average makes far smaller than the first: the
    largest difference stays inside its bound, the relative Frobenius
    one does not."""
    tfa = ct.tfa
    real = tfa.flash_fwd
    S = 512

    def nudged(q, k, v, cfg):
        out, lse = real(q, k, v, cfg)
        late = out[:, S // 4:].float() * 1.05
        return torch.cat([out[:, :S // 4], late.to(out.dtype)], dim=1), lse

    gen = torch.Generator().manual_seed(0)
    q = (0.05 * torch.randn((2, S, 2, 16), generator=gen)).to(torch.bfloat16)
    k, v = (torch.randn((2, S, 2, 16), generator=gen).to(torch.bfloat16)
            for _ in range(2))
    check = ct.PlainCheck()
    tfa.flash_fwd = nudged
    try:
        with pytest.raises(ct.PlainMismatch, match="K4 off its plain version"):
            with check.active("late rows"):
                sweep.flash_attention(q, k, v)
    finally:
        tfa.flash_fwd = real
    call = check.calls[-1]
    assert call["err"]["out"] < call["tol"]["out"]
    assert call["rel"]["out"] > call["rel_tol"]["out"] == 2.0 ** -6


def test_train_step_stays_strict_on_an_unread_leaf():
    """The port's train step raises on a leaf its loss does not read (a
    cut-off shard fails loudly); the mfu breakdown's no-attention model
    reads ``wqkv`` with weight 0, so its step runs and gives zeros."""
    cfg = tt.tiny_config()
    tx = AdamW(1e-3)
    tokens = torch.randint(0, cfg.vocab_size, (2, 17),
                           generator=torch.Generator().manual_seed(0))

    def step_with(attention):
        params = tt.init_params(cfg, 0, "cpu")
        return _patched(tt, "_attention", attention,
                        lambda: tt.make_train_step(cfg, tx)(
                            params, tx.init(params), tokens))

    with pytest.raises(RuntimeError, match="not have been used"):
        step_with(lambda cfg, p, x: x @ p["wo"].to(cfg.dtype))
    _, opt_state, loss = step_with(mfu.no_attention)
    assert torch.isfinite(loss)
    for block in opt_state["mu"]["blocks"]:
        assert not block["attn"]["wqkv"].any()


def test_expect_launches_on_the_card_counts_per_call():
    row = {"row": "r", "warm": 1, "iters": 3,
           "launches": {"flash_fwd": 32, "flash_bwd": 64}}
    ct.expect_launches(row, torch.device("cuda"), 8, 16)
    with pytest.raises(RuntimeError, match="expected"):
        ct.expect_launches(row, torch.device("cuda"), 0, 0)
    with pytest.raises(RuntimeError, match="expected"):
        ct.expect_launches(row, CPU, 8, 16)


@pytest.mark.parametrize("mode", abl.MODES)
def test_ablation_modes_run(tmp_path, monkeypatch, mode):
    monkeypatch.setenv("EXP_ABL", mode)
    monkeypatch.setenv("EXP_B", "2")
    out = tmp_path / "rows.json"
    real_loss = tt.next_token_loss
    assert abl.main(["--device", "cpu", "--size", "tiny", "--warm", "1",
                     "--iters", "1", "--json", str(out)]) == 0
    res = json.loads(out.read_text())
    labels = [r["row"] for r in res["rows"]]
    assert res["mode"] == mode and res["batch"] == 2
    assert not any("fail" in r for r in res["rows"])
    if mode == "layers":
        assert labels == ["flash L=0 B=2", "flash L=2 B=2", "flash L=4 B=2",
                          "fit"]
    elif mode == "fused":
        assert labels == ["eager L=0", "eager L=2"]  # graphs need the card
    elif mode == "loss":
        assert labels == [f"head loss={v} B=2" for v in abl.LOSS_VARIANTS]
        assert tt.next_token_loss is real_loss  # restored
    else:
        assert labels == ["dense B=2", "flash B=2 bq=64 bk=64",
                          "flash B=2 bq=64 bk=32"]
        assert [r.get("path") for r in res["rows"]] == [
            None, "fast", "general"]


def test_flash_sweep_model_mode_runs(tmp_path, monkeypatch):
    monkeypatch.setenv("EXP_MODE", "model")
    monkeypatch.setenv("EXP_ONLY", "B4")
    out = tmp_path / "rows.json"
    assert sweep.main(["--device", "cpu", "--size", "tiny", "--warm", "1",
                       "--iters", "1", "--json", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert [r["row"] for r in rows] == ["model dense_B4", "model flash_B4"]
    assert all(r["steps_per_s"] > 0 for r in rows)


def test_smoke_experiments_phase_on_the_cpu(tmp_path):
    """chip_smoke.py's experiments phase at tiny widths: its worker
    process, every row of both scripts, each K4/K5 call held."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    res = cs.phase_experiments(str(tmp_path), device="cpu", size="tiny")
    summ = cs.check_experiments(res, on_card=False)
    rows = {r["row"]: r for r in summ["rows"]}
    calls = (cs.EXP_WARM + cs.EXP_ITERS) * tt.tiny_config().n_layers
    assert rows["step_full"]["check"]["K4"]["calls"] == calls
    assert rows["step_full"]["check"]["K5"]["calls"] == calls
    assert rows["step_no_attn"]["check"] == {}
    assert rows["B2 S63 ours bq=64 bk=32"]["check"]["K5"]["calls"] == (
        cs.EXP_WARM + cs.EXP_ITERS)
    assert summ["launches"] == {"flash_fwd": 0, "flash_bwd": 0}


def test_join_repro_late_group_joins_a_quorum_of_three():
    proc = subprocess.run(
        [sys.executable, "experiments/join_starvation_repro_torch.py",
         "--device", "cpu"],
        cwd=REPO, env={**_env(), "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("elapsed "))
    groups = json.loads(line.split(" ", 2)[2])
    assert sorted(groups) == ["0", "1", "2"]
    assert groups["2"]["first_3party_s"] is not None
    assert groups["2"]["commits_in_3party"] >= 1
    assert all(g["final_step"] >= 200 for g in groups.values())


def test_verify_e2e_on_the_cpu(tmp_path):
    proc = subprocess.run(
        ["bash", "experiments/verify_e2e_torch.sh"], cwd=REPO,
        env={**_env(), "DEVICE": "cpu", "NUM_STEPS": "3000",
             "OMP_NUM_THREADS": "1", "WORKDIR": str(tmp_path)},
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    assert "E2E VERIFY OK" in proc.stdout
    with open(tmp_path / "g1b.log") as f:
        assert "healing from" in f.read()


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_experiment_raises_without_a_card(name):
    proc = subprocess.run(
        [sys.executable, f"experiments/{name}.py"], cwd=REPO,
        env={**_env(), "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr

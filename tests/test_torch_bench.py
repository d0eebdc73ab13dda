"""``bench_torch.py``, the port's FT-against-raw harness, held against
``bench.py`` (imported, not edited) on the CPU, and the three experiments
that import it.

- ``_timed_window`` and ``_probe_backend_child``: the cases of
  ``tests/test_bench_helpers.py``, on both modules.
- ``_model_setup``: every size, on the card branch and the CPU branch,
  has bench.py's config fields (TPU and CPU branches), batch shape and
  parameter count (counted from shapes: big2's ~323M parameters are not
  allocated); the CPU batches are bench.py's tokens.
- The ring peer's zero tree per ``BENCH_PEER_DTYPE``: bench.py's peer's
  structure, shapes and dtypes.
- Fixed-step FT sessions over a live 2-member ring, each against the JAX
  side driven through ``bench._ring_session``, from one init
  (``params_from_jax``) and one batch at bench's 2-layer CPU config. The
  models compute in f32 on both sides: the default bf16 matmuls of XLA
  and of torch round differently on the CPU, which is the transformer
  tests' business, not the harness's.
  - blocking and pipelined on the f32 wire: every step's applied average
    is the port's own gradient over the JAX session's participant count
    for that step, bit for bit (the peer sends zeros and takes part in
    the first step only: 2, then 1), and within F6 (rtol 1e-5 / atol
    1e-6) of the JAX side's applied average (``_assert_average_close``);
    the final params to F6 on all but 1 in 1,000 elements of each leaf,
    and all to 2 lr a step (AdamW moves a near-zero gradient's element
    by a fraction of lr that its last bits decide;
    ``_assert_adamw_close``). AdamW hides a gradient's scale, so the
    averages are what hold the divisor.
  - int8 at ``ddp_small`` (d_model 128, S 2048, batch 1): every step's
    payload (codes, scales, shipped values, carry) bit for bit against
    the JAX ``quantize_with_feedback`` run eagerly on the port's own
    gradients and carry; every step's gathered entries (the port's
    payload, then the peer's zeros) and their member-wise average bit for
    bit against the JAX ``make_dequant_average`` on the same entries and
    the JAX session's participant count, and that average is what the
    step applies; the final params as for f32 (a code may round the
    other way where the two packages' gradients differ in their last
    bits).
  - one ``_DilocoHarness`` window of fixed steps on the bf16 wire
    (after the warm-up's two syncs): the final params as for f32, but
    most elements to one bf16 ulp of a delta through the outer step in
    place of 1e-6 (the packages' f32 deltas may round to bf16 one ulp
    apart; each delta's cast is held bit for bit against its plain
    version by the smoke's bench phase).
- ``bench_torch.py`` end to end with ``--device cpu`` and a small
  ``BENCH_ATTEMPT_TIMEOUT_S`` (100 s: a tenth of the windows): its
  ``--out`` JSON has a ring of 2 and every phase measured or skipped
  for time.
- Without a card and without ``--device cpu``, ``bench_torch.py`` and each
  new experiment exit non-zero naming the missing card; none of them
  imports JAX, optax, ``bench.py`` or the JAX package.
- The three experiments at ``--size tiny``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch_one_thread  # noqa: E402,F401

import bench  # noqa: E402
import bench_torch  # noqa: E402
from torchft_tpu.models import transformer as jt  # noqa: E402
from torchft_tpu import quantize as jax_quantize_mod  # noqa: E402
from torchft_tpu.quantize import quantize_with_feedback as jax_quantize  # noqa: E402
from torchft_tpu_torch import AdamW  # noqa: E402
from torchft_tpu_torch import ddp as ddp_mod  # noqa: E402
from torchft_tpu_torch._tree import flatten, tree_map  # noqa: E402
from torchft_tpu_torch.models import transformer as tt  # noqa: E402

MODULES = [bench, bench_torch]
EXPERIMENTS = ("ddp_phase_breakdown_torch.py", "ddp_modes_torch.py",
               "ddp_small_tpu_breakdown_torch.py")
LR = 1e-3


# ---- the wall-clock window and the backend probe (test_bench_helpers) ----


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m.__name__)
class TestTimedWindow:
    def test_budget_exhaustion_returns_instead_of_wedging(self, mod):
        calls = {"n": 0}

        def run_step():
            calls["n"] += 1
            time.sleep(0.002)

        t0 = time.perf_counter()
        n, el = mod._timed_window(run_step, drain=lambda: None,
                                  budget_s=0.15, rate_hint=100)
        assert n == calls["n"] > 0
        assert el >= 0.15
        assert time.perf_counter() - t0 < 10

    def test_max_steps_caps_the_window(self, mod):
        n, el = mod._timed_window(lambda: None, drain=lambda: None,
                                  budget_s=60, max_steps=7, rate_hint=1000)
        assert n == 7
        assert el < 10

    def test_degrading_rate_shortens_interval(self, mod):
        state = {"n": 0}

        def run_step():
            state["n"] += 1
            time.sleep(0.0001 if state["n"] < 50 else 0.01)

        t0 = time.perf_counter()
        mod._timed_window(run_step, drain=lambda: None, budget_s=0.3,
                          rate_hint=10000)
        assert time.perf_counter() - t0 < 10


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m.__name__)
class TestBackendProbe:
    def test_probe_success_reports_platform(self, mod):
        plat = mod._probe_backend_child(
            deadline_s=60, _cmd=[sys.executable, "-c", "print('cpu')"])
        assert plat == "cpu"

    def test_probe_hang_times_out_fast(self, mod):
        t0 = time.monotonic()
        plat = mod._probe_backend_child(
            deadline_s=0.3, tries=2,
            _cmd=[sys.executable, "-c", "import time; time.sleep(60)"])
        assert plat is None
        assert time.monotonic() - t0 < 10

    def test_probe_crash_is_failure_not_exception(self, mod):
        plat = mod._probe_backend_child(
            deadline_s=30, _cmd=[sys.executable, "-c", "raise SystemExit(2)"])
        assert plat is None


def test_acquire_refuses_instead_of_falling_back(monkeypatch):
    """A probe that finds no card (or none that answers) refuses the run;
    ``--device cpu`` is taken as asked, without a probe."""
    for plat in ("cpu", None):
        monkeypatch.setattr(bench_torch, "_probe_backend_child",
                            lambda plat=plat: plat)
        with pytest.raises(bench_torch.NoCard, match="no CUDA device"):
            bench_torch._acquire_backend()
    monkeypatch.setattr(bench_torch, "_probe_backend_child", None)
    assert bench_torch._acquire_backend("cpu") == torch.device("cpu")


# ---- the scripts as a user runs them: started at once, each test waits --
# for its own (the end-to-end run, the refusals, the experiments)

END_TO_END = ("bench_torch.py", "--device", "cpu")
NO_IMPORT = ("bench_torch.py", *(f"experiments/{e}" for e in EXPERIMENTS))
# loads each script as a module (not running it), then lists what they
# pulled in
_NO_IMPORT_CODE = (
    "import importlib.util, sys\n"
    f"for path in {NO_IMPORT!r}:\n"
    "    spec = importlib.util.spec_from_file_location('tool', path)\n"
    "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
    "    print(path)\n"
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'optax', 'ml_dtypes', 'torchft_tpu', 'bench'))\n"
    "assert not bad, bad\n")
REFUSALS = {"bench_torch.py": ("bench_torch.py",),
            **{e: (f"experiments/{e}",) for e in EXPERIMENTS}}


def _run(argv):
    """``(returncode, stdout, stderr)`` of a light script run (one torch
    thread)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, *argv], cwd=REPO,
                          env={**env, "OMP_NUM_THREADS": "1"},
                          capture_output=True, text=True, timeout=180)
    return proc.returncode, proc.stdout, proc.stderr


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The file's script runs as a user runs them (the end-to-end run,
    the three experiments, the refusals), started together: ``{name:
    (proc, out path)}``."""
    tmp = tmp_path_factory.mktemp("bench_runs")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = {}

    def start(name, argv, out, **extra):
        runs[name] = (subprocess.Popen(
            [sys.executable, *argv], cwd=REPO, env={**env, **extra},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out)

    out = tmp / "bench.json"
    start("end to end", [*END_TO_END, "--out", str(out)], out,
          BENCH_ATTEMPT_TIMEOUT_S="100", OMP_NUM_THREADS="2")
    for e in EXPERIMENTS:
        out = tmp / f"{e}.json"
        start(e, [f"experiments/{e}", "--device", "cpu", "--size", "tiny",
                  "--json", str(out)], out, OMP_NUM_THREADS="2")
    for name, argv in REFUSALS.items():
        start(f"refusal {name}", argv, None, OMP_NUM_THREADS="1")
    yield runs
    for proc, _ in runs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def _finish(launched, name):
    """``(returncode, stdout, stderr, out path)`` of a launched run."""
    proc, out = launched[name]
    stdout, stderr = proc.communicate(timeout=300)
    return proc.returncode, stdout, stderr, out


# ---- model sizes ------------------------------------------------------------

SIZES = ("small", "ddp_small", "big", "big2")
FIELDS = ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff",
          "max_seq_len", "use_flash")


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform


def _jax_setup(size, platform, monkeypatch):
    """bench.py's ``_model_setup`` on the branch ``platform`` takes."""
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(platform)])
    return bench._model_setup(size)


def _jax_param_count(cfg) -> int:
    shapes = jax.eval_shape(lambda: jt.init_params(cfg, jax.random.PRNGKey(0)))
    return sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(shapes))


@pytest.mark.parametrize("on_card", [True, False], ids=["card", "cpu"])
@pytest.mark.parametrize("size", SIZES)
def test_model_setup_matches_bench(size, on_card, monkeypatch):
    monkeypatch.delenv("BENCH_FORCE_LAYERS", raising=False)
    monkeypatch.delenv("BENCH_DDP_SMALL_BATCH", raising=False)
    jcfg, jbatch, on_tpu = _jax_setup(size, "tpu" if on_card else "cpu",
                                      monkeypatch)
    assert on_tpu is on_card
    cfg, batch_size, seq_len = bench_torch._model_config(size, on_card)
    assert {f: getattr(cfg, f) for f in FIELDS} == \
        {f: getattr(jcfg, f) for f in FIELDS}
    assert (batch_size, seq_len) == tuple(jbatch.shape)
    assert bench_torch._n_params(cfg) == _jax_param_count(jcfg)
    if not on_card:
        tcfg, tbatch, tcard = bench_torch._model_setup(size, "cpu")
        assert tcfg == cfg and tcard is False
        assert tbatch.dtype == torch.int64
        np.testing.assert_array_equal(tbatch.numpy(), np.asarray(jbatch))
    if size in ("small", "ddp_small") and not on_card:
        assert bench_torch._n_params(cfg) == tt.param_count(
            tt.init_params(cfg, 0, "cpu"))


def test_forced_layers_reach_both_branches(monkeypatch):
    """The peer builds main's tree on the CPU: main exports its layers."""
    monkeypatch.setenv("BENCH_FORCE_LAYERS", "6")
    cfg, _, _ = bench_torch._model_setup("small", "cpu")
    jcfg, _, _ = _jax_setup("small", "cpu", monkeypatch)
    assert cfg.n_layers == jcfg.n_layers == 6


# ---- the peer's zero tree ---------------------------------------------------


def _jax_peer_zeros(params, peer_dtype):
    """bench.py's ``peer`` builds its zeros inline (bench.py:382-405);
    the same expressions."""
    if peer_dtype == "int8":
        return {
            "q": jax.tree_util.tree_map(
                lambda l: jnp.zeros(l.shape, jnp.int8), params),
            "scale": jax.tree_util.tree_map(
                lambda l: jnp.zeros((), jnp.float32), params),
        }
    if peer_dtype == "q8":
        return jax.tree_util.tree_map(
            lambda l: jnp.zeros(l.shape, jnp.float32), params)
    wire_dtype = jnp.bfloat16 if peer_dtype == "bf16" else None
    return jax.tree_util.tree_map(
        lambda l: jnp.zeros(l.shape, wire_dtype or l.dtype), params)


def _layout(tree, prefix=""):
    """{path: (shape, dtype name)} of a nested dict/list tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_layout(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_layout(v, f"{prefix}/{i}"))
        return out
    dtype = str(tree.dtype).replace("torch.", "")
    return {prefix: (tuple(tree.shape), dtype)}


@pytest.mark.parametrize("peer_dtype", ["int8", "q8", "bf16", "f32"])
def test_peer_zero_tree_matches_bench(peer_dtype):
    cfg, _, _ = bench_torch._model_setup("small", "cpu")
    jcfg = jt.TransformerConfig(**{f: getattr(cfg, f) for f in FIELDS})
    jzeros = _jax_peer_zeros(jt.init_params(jcfg, jax.random.PRNGKey(0)),
                             peer_dtype)
    tzeros = bench_torch._peer_zeros(tt.init_params(cfg, 0, "cpu"),
                                     peer_dtype)
    assert _layout(tzeros) == _layout(jzeros)
    assert all(float(l.abs().max()) == 0 for l in flatten(tzeros)[0])


# ---- fixed-step sessions against bench.py's ---------------------------------


def _f32_configs(size):
    """The port's and the JAX package's config of a size's CPU branch,
    computing in f32."""
    cfg, batch, _ = bench_torch._model_setup(size, "cpu")
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    jcfg = jt.TransformerConfig(**{f: getattr(cfg, f) for f in FIELDS},
                                dtype=jnp.float32)
    return cfg, jcfg, batch


def _jax_ddp(mode, wire, jcfg, jparams, batch, steps):
    """bench.py's per-step DDP loops (``_run_ft_ddp_phase.run_ddp``,
    ``_bench_ddp_small.run_session``) at a fixed step count, through
    ``bench._ring_session``. Returns the final params, the commits and
    each step's participants (the peer takes part in round 0 only: its
    step stays 0, so it leaves the max-step cohort after it)."""
    from torchft_tpu import FTTrainState, OptimizerWrapper, PipelinedDDP

    grad_fn = _jax_grad_fn(jcfg)
    state = FTTrainState(jparams, optax.adamw(LR))
    tokens = jnp.asarray(batch.numpy().astype(np.int32))
    commits, participants = [], []
    with bench._ring_session(f"t_{mode}", wire, state) as (manager, coll):
        if mode == "blocking":
            optimizer = OptimizerWrapper(manager, state)
            for _ in range(steps):
                optimizer.zero_grad()
                _, grads = grad_fn(state.params, tokens)
                avg = manager.allreduce(grads).wait()
                commits.append(optimizer.step(avg))
                participants.append(manager.num_participants())
        else:
            ddp = PipelinedDDP(manager, state, grad_fn,
                               compress="int8" if wire == "int8" else None)
            for _ in range(steps):
                ddp.step(tokens)
                participants.append(manager.num_participants())
            commits.append(ddp.flush())
        assert coll.size() == 2
    return (jax.tree_util.tree_map(np.asarray, state.params), commits,
            participants)


def _assert_adamw_close(port_params, jax_params, steps, atol=1e-6):
    """``atol`` (F6's f32 1e-6 by default) with rtol 1e-5 on all but 1 in
    1,000 elements of every leaf, and 2 lr a step on all: AdamW divides
    each element by its own running RMS, so a gradient near zero (near
    eps) whose last bits XLA's and torch's f32 sums give differently
    moves by another fraction of lr, up to the whole step either way
    (measured after two steps: f32, at most 8 of a 786,432-element
    leaf's elements past the F6 bound; int8, where a code also rounds
    the other way, at most 1 of a 16,384-element leaf's, 6.1e-5; after
    three steps, 62 of a 262,144-element leaf's, up to 2.2e-4)."""
    got = flatten(port_params)[0]
    want = jax.tree_util.tree_leaves(jax_params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().numpy()
        off = ~np.isclose(g, w, rtol=1e-5, atol=atol)
        assert off.mean() <= 1e-3, (off.sum(), off.size)
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * LR * steps)


def _assert_average_close(port, jax_side, first):
    """One step's applied averages, leaf by leaf, at F6 (rtol 1e-5 / atol
    1e-6): on every element at the first step, where both sides take
    their gradients at the one init; after it, on all but 1 in 1,000
    elements of each leaf and at most one of a smaller leaf, since the
    params the gradients are taken at have parted as
    ``_assert_adamw_close`` allows (measured at the second step, blocking
    and pipelined: at most 188 of a 786,432-element leaf's elements, 150
    of a 262,144-element one's, 1 of a 512-element one's)."""
    assert len(port) == len(jax_side)
    for p, j in zip(port, jax_side):
        off = ~np.isclose(p, j, rtol=1e-5, atol=1e-6)
        assert off.sum() <= (0 if first else max(1, 1e-3 * off.size)), \
            (off.sum(), off.size)


def _leaves_np(tree) -> list:
    """A port tree's leaves as numpy copies, in tree order."""
    return [l.detach().clone().numpy() for l in flatten(tree)[0]]


@pytest.fixture
def applied(monkeypatch):
    """Every gradient tree an optimizer step applies, on each side, as
    numpy leaves in tree order: ``{"port": [...], "jax": [...]}``."""
    from torchft_tpu import FTTrainState as JState

    from torchft_tpu_torch import FTTrainState

    seen = {"port": [], "jax": []}
    port_apply, jax_apply = FTTrainState.apply_gradients, JState.apply_gradients

    def port(self, grads):
        seen["port"].append(_leaves_np(grads))
        return port_apply(self, grads)

    def jax_side(self, grads):
        seen["jax"].append([np.array(l)
                            for l in jax.tree_util.tree_leaves(grads)])
        return jax_apply(self, grads)

    monkeypatch.setattr(FTTrainState, "apply_gradients", port)
    monkeypatch.setattr(JState, "apply_gradients", jax_side)
    return seen


def _recording(grad_fn, into: list):
    """``grad_fn`` that also appends each call's gradients to ``into``."""
    def wrapped(params, *batch):
        loss, grads = grad_fn(params, *batch)
        into.append(_leaves_np(grads))
        return loss, grads
    return wrapped


@pytest.fixture
def torch_threads():
    """Four intra-op threads for a test that trains the 2-layer model on
    both sides (the file's other tests keep one)."""
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


_JAX_GRAD_FNS: dict = {}


def _jax_grad_fn(jcfg):
    """One jitted JAX gradient function per config (one compile)."""
    if jcfg not in _JAX_GRAD_FNS:
        _JAX_GRAD_FNS[jcfg] = jax.jit(
            jax.value_and_grad(lambda p, b: jt.loss_fn(jcfg, p, b)))
    return _JAX_GRAD_FNS[jcfg]


@pytest.mark.parametrize("mode", ["blocking", "pipelined"])
def test_f32_session_matches_bench(mode, torch_threads, applied):
    cfg, jcfg, batch = _f32_configs("small")
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    timed = 1  # after the warm step
    grads = []
    res = bench_torch._ft_ddp_session(
        mode, "f32", cfg, AdamW(LR), _recording(tt.make_grad_fn(cfg), grads),
        batch, 600.0, "cpu", max_steps=timed,
        params=tt.params_from_jax(jparams, "cpu"))
    assert res["steps"] == timed and res["ring_size"] == 2
    assert all(res["commits"]) and max(res["participants"]) == 2
    want, jcommits, jparts = _jax_ddp(mode, "f32", jcfg, jparams, batch,
                                      1 + timed)
    assert len(res["commits"]) == 1 + timed and all(jcommits)
    # the average each step applied: this member's gradient over the
    # step's participants (the JAX session's: 2, then 1), the peer's
    # zeros adding nothing
    assert res["participants"] == jparts and jparts[0] == 2
    assert len(grads) == len(applied["port"]) == len(applied["jax"]) == 1 + timed
    for step, (g, n, got, jgot) in enumerate(zip(
            grads, jparts, applied["port"], applied["jax"])):
        assert [(l / np.float32(n)).tobytes() for l in g] == \
            [l.tobytes() for l in got]
        _assert_average_close(got, jgot, first=step == 0)
    _assert_adamw_close(res["state"].params, want, 1 + timed)


def test_int8_session_payloads_and_trajectory(monkeypatch, torch_threads,
                                              applied):
    monkeypatch.setenv("BENCH_MODEL", "ddp_small")
    monkeypatch.setenv("BENCH_DDP_SMALL_BATCH", "1")
    cfg, jcfg, batch = _f32_configs("ddp_small")
    assert batch.shape == (1, 2048) and cfg.d_model == 128
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    calls, combines, jax_n = [], [], []
    real = ddp_mod.quantize_with_feedback
    real_combine = ddp_mod.make_dequant_average
    real_jax_combine = jax_quantize_mod.make_dequant_average

    def record(tree, residual, **kw):
        out = real(tree, residual, **kw)
        calls.append((tree_map(torch.clone, tree),
                      tree_map(torch.clone, residual),
                      tree_map(torch.clone, out)))
        return out

    def recording_combine():
        combine = real_combine()

        def run(entries, n):
            out = combine(entries, n)
            combines.append(([tree_map(torch.clone, e) for e in entries], n,
                             _leaves_np(out)))
            return out
        return run

    def jax_recording_combine():
        combine = real_jax_combine()

        def run(entries, n):
            jax_n.append(float(n))
            return combine(entries, n)
        return run

    monkeypatch.setattr(ddp_mod, "quantize_with_feedback", record)
    monkeypatch.setattr(ddp_mod, "make_dequant_average", recording_combine)
    monkeypatch.setattr(jax_quantize_mod, "make_dequant_average",
                        jax_recording_combine)
    timed = 1
    res = bench_torch._ddp_small_session(
        cfg, AdamW(LR), tt.make_grad_fn(cfg), batch, 600.0, timed, "t_int8",
        "cpu", params=tt.params_from_jax(jparams, "cpu"))
    assert res["steps"] == timed and res["ring_size"] == 2
    assert all(res["commits"]) and len(calls) == 1 + timed
    as_np = lambda t: jax.tree_util.tree_map(  # noqa: E731
        np.asarray, tree_map(lambda l: l.numpy(), t))
    bits = lambda leaves: [np.asarray(l).tobytes() for l in leaves]  # noqa: E731
    for tree, residual, out in calls:
        with jax.disable_jit():
            want = jax_quantize(as_np(tree), as_np(residual))
        for k in ("q", "scale", "dq", "res"):
            assert bits(l.numpy() for l in flatten(out[k])[0]) == \
                bits(jax.tree_util.tree_leaves(want[k])), k
    want, _, jparts = _jax_ddp("pipelined", "int8", jcfg, jparams, batch,
                               1 + timed)
    # each step's gathered entries are this member's payload, then the
    # peer's zeros; their average is the JAX combine's on the same entries
    # over the JAX session's participants (2, then 1), and it is what the
    # step applied
    assert len(combines) == len(jax_n) == len(applied["port"]) == 1 + timed
    assert res["participants"] == jparts and jparts[0] == 2
    jax_combine = real_jax_combine()
    for (_, _, out), (entries, n, avg), n_jax, got in zip(
            calls, combines, jax_n, applied["port"]):
        assert len(entries) == 2 and n == n_jax
        for k in ("q", "scale"):
            assert bits(l.numpy() for l in flatten(entries[0][k])[0]) == \
                bits(l.numpy() for l in flatten(out[k])[0]), k
            assert all(not l.any() for l in flatten(entries[1][k])[0]), k
        expect = jax_combine([as_np(e) for e in entries], n_jax)
        assert bits(avg) == bits(jax.tree_util.tree_leaves(expect))
        assert bits(got) == bits(avg)
    _assert_adamw_close(res["state"].params, want, 1 + timed)


def test_diloco_window_matches_bench(torch_threads):
    cfg, jcfg, batch = _f32_configs("small")
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    from torchft_tpu import FTTrainState as JState

    from torchft_tpu_torch import FTTrainState

    warm, steps = 1, 2
    tx = AdamW(LR)
    h = bench_torch._DilocoHarness(
        FTTrainState(tt.params_from_jax(jparams, "cpu"), tx),
        tt.make_train_step(cfg, tx), batch, "bf16", overlap=True, tag="t",
        device="cpu")
    try:
        h.warm(warm)
        win = h.window(600.0, max_steps=steps)
        assert win["steps"] == steps and win["committed"]
        assert h.collectives.size() == 2 and all(h.commits)
        got = h.state.params
    finally:
        h.close()
    jtx = optax.adamw(LR)
    jh = bench._DilocoHarness(
        JState(jparams, jtx), jt.make_train_step(jcfg, jtx),
        jnp.asarray(batch.numpy().astype(np.int32)), "bf16", overlap=True,
        tag="t")
    try:
        jh.warm(warm)
        for _ in range(steps):  # bench.py's window at a fixed step count
            jh._run_step()
        jh.diloco.sync()
        jh.diloco.flush()
        want = jax.tree_util.tree_map(np.asarray, jh.state.params)
    finally:
        jh.close()
    # the bound on most elements: one bf16 ulp (2^-7 of the value) of a
    # delta of at most lr a step, through the outer step (0.7 with
    # Nesterov momentum 0.9 over a few syncs: under 2x)
    _assert_adamw_close(got, want, warm + steps,
                        atol=2 * 2.0 ** -7 * LR * (warm + steps))


# ---- the script end to end, the refusals, the experiments ------------------


def test_bench_end_to_end_on_the_cpu(launched):
    rc, stdout, stderr, out = _finish(launched, "end to end")
    assert rc == 0, stderr[-3000:]
    metric = json.loads(stdout.strip().splitlines()[-1])
    assert metric["metric"] == "steps_per_sec_ft" and metric["platform"] == "cpu"
    detail = json.loads(out.read_text())
    assert detail["host"]["platform"] == "cpu"
    assert detail["ft_diloco"]["ring_size"] == 2
    assert all(detail["ft_diloco"]["sync_committed"])
    for phase in ("raw", "transfer", "ft_diloco", "ft_ddp"):
        r = detail[phase]
        assert "error" not in r
        assert r.get("skipped") == "time budget" or any(
            isinstance(v, float) and v > 0 for v in r.values()), (phase, r)
    assert detail["raw"]["steps_per_sec"] > 0
    assert not any(k in detail for k in ("ft_ddp_small", "big", "big2"))


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refuses_without_a_card(launched, name):
    rc, stdout, stderr, _ = _finish(launched, f"refusal {name}")
    assert rc != 0
    assert "no CUDA device" in stderr
    assert '{"metric"' not in stdout


def test_imports_neither_jax_nor_bench():
    """The harness and the experiments, loaded together in one process,
    import no JAX, no optax, no ``bench.py`` and nothing of the JAX
    package."""
    rc, stdout, stderr = _run(["-c", _NO_IMPORT_CODE])
    assert rc == 0, stderr[-2000:]
    assert stdout.split() == list(NO_IMPORT)


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_experiment_at_tiny_size(launched, name):
    rc, stdout, stderr, out = _finish(launched, name)
    assert rc == 0, (stdout + stderr)[-3000:]
    res = json.loads(out.read_text())
    assert res["device"] == "cpu" and res["size"] == "tiny"
    if name == "ddp_phase_breakdown_torch.py":
        assert res["ring_size"] == 2 and res["median_ms"]["grad"] > 0
    elif name == "ddp_modes_torch.py":
        assert set(res["modes"]) == {"blocking", "pipelined", "pipelined_bf16"}
        assert all(m["steps_per_sec"] > 0 for m in res["modes"].values())
    else:
        assert set(res["serialized_median_s"]) == {
            "grad", "quant", "quorum", "dispatch", "ring_wait", "vote",
            "combine", "apply", "total"}
        assert res["pipelined_steps_per_sec"] > 0
        assert set(res["pipelined_op_median_s"]) >= {"pack", "ring", "h2d"}

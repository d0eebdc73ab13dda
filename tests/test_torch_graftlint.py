"""graftlint's path-bound rules over the port (``scripts/graftlint_torch.py``):
the tree is clean, and each rule fails on a copy of the port's files with
one violation seeded into it."""

import ast
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_spec = importlib.util.spec_from_file_location(
    "graftlint_torch", REPO / "scripts" / "graftlint_torch.py")
glt = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(glt)


def _copy_tree(dst: Path) -> Path:
    """The files the three rules read, copied to ``dst`` at their paths."""
    for rel in [*glt.env_scan_files(REPO), Path("docs/OPERATIONS.md")]:
        (dst / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / rel, dst / rel)
    return dst


def _insert_first(path: Path, cls: str, method: str, line: str) -> None:
    """Puts ``line`` as the first statement of ``cls.method`` in ``path``."""
    text = path.read_text()
    tree = ast.parse(text)
    klass = next(n for n in tree.body
                 if isinstance(n, ast.ClassDef) and n.name == cls)
    fn = next(n for n in klass.body
              if isinstance(n, ast.FunctionDef) and n.name == method)
    first = fn.body[0]
    lines = text.splitlines(keepends=True)
    lines.insert(first.lineno - 1, " " * first.col_offset + line + "\n")
    path.write_text("".join(lines))


def test_the_port_is_clean():
    assert glt.run(REPO) == []
    proc = subprocess.run([sys.executable, "scripts/graftlint_torch.py"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "graftlint_torch: clean" in proc.stdout


def test_the_rules_read_the_port_files():
    scanned = {str(p) for p in glt.env_scan_files(REPO)}
    assert "torchft_tpu_torch/manager.py" in scanned
    assert "torchft_tpu_torch/ops/flash_attention.py" in scanned
    assert "scripts/chaos_run_torch.py" in scanned
    assert "scripts/graftlint_torch.py" in scanned
    assert "examples/train_ddp_torch.py" in scanned
    assert not any(s.startswith("torchft_tpu/") for s in scanned)
    assert glt.PLANS_TARGET == {("torchft_tpu_torch/collectives.py", "_plans"): (
        "__init__", "configure", "_plan_for", "_sharded_plan_for")}


def test_a_clean_copy_is_clean(tmp_path):
    assert glt.run(_copy_tree(tmp_path)) == []


def test_latch_discipline_bites(tmp_path):
    root = _copy_tree(tmp_path)
    _insert_first(root / "torchft_tpu_torch/manager.py", "Manager",
                  "allreduce", 'raise RuntimeError("seeded")')
    found = glt.run(root)
    assert [(v.rule, v.file) for v in found] == [
        ("latch_discipline", "torchft_tpu_torch/manager.py")]
    assert "raises a non-ValueError" in found[0].message
    assert "Manager.allreduce" in found[0].message


def test_cache_mutation_bites(tmp_path):
    root = _copy_tree(tmp_path)
    _insert_first(root / "torchft_tpu_torch/collectives.py", "HostCollectives",
                  "shutdown", "self._plans.clear()")
    found = glt.run(root)
    assert [(v.rule, v.file) for v in found] == [
        ("cache_mutation", "torchft_tpu_torch/collectives.py")]
    assert "self._plans .clear() in shutdown()" in found[0].message


@pytest.mark.parametrize("rel", ["torchft_tpu_torch/manager.py",
                                 "scripts/chaos_run_torch.py",
                                 "examples/train_ddp_torch.py"])
def test_env_docs_bites(tmp_path, rel):
    root = _copy_tree(tmp_path)
    with open(root / rel, "a") as f:
        f.write('\n_SEEDED = os.environ.get("TORCHFT_SEEDED_UNDOCUMENTED")\n')
    found = glt.run(root)
    assert [(v.rule, v.file) for v in found] == [("env_docs", rel)]
    assert "TORCHFT_SEEDED_UNDOCUMENTED" in found[0].message


@pytest.mark.parametrize("rel", ["bench_torch.py", "bench_churn_torch.py",
                                 "experiments/ddp_modes_torch.py"])
def test_env_docs_scans_the_bench_harness(tmp_path, rel):
    """The bench harnesses and the experiments are in the rule's scan (the
    knobs they read or set, ``TORCHFT_HC_PIPELINE_CHUNKS``,
    ``TORCHFT_ZYGOTE`` and ``TORCHFT_STANDBY_FILE`` among them, are
    documented), and a knob read there undocumented fails it."""
    assert Path(rel) in glt.env_scan_files(REPO)
    root = _copy_tree(tmp_path)
    with open(root / rel, "a") as f:
        f.write('\n_SEEDED = os.environ.get("TORCHFT_SEEDED_UNDOCUMENTED")\n')
    found = glt.run(root)
    assert [(v.rule, v.file) for v in found] == [("env_docs", rel)]


def test_cli_exits_1_on_a_violation(tmp_path):
    root = _copy_tree(tmp_path)
    _insert_first(root / "torchft_tpu_torch/collectives.py", "HostCollectives",
                  "shutdown", "self._plans = {}")
    proc = subprocess.run(
        [sys.executable, "scripts/graftlint_torch.py", "--root", str(root),
         "cache_mutation"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode == 1
    assert "[cache_mutation] self._plans rebound in shutdown()" in proc.stdout

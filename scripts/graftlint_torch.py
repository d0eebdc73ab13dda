#!/usr/bin/env python3
"""graftlint's path-bound rules over the PyTorch port.

``scripts/graftlint.py`` runs every rule on the JAX package's paths. Three
of them read fixed paths there; this script calls the same rules'
``check`` functions (``tools.graftlint``, unchanged) with the port's:

- ``latch_discipline``: ``Manager`` in ``torchft_tpu_torch/manager.py``
  routes every managed collective through ``_managed_dispatch`` and raises
  nothing but an eager ``ValueError`` on that path;
- ``cache_mutation``: ``HostCollectives._plans`` in
  ``torchft_tpu_torch/collectives.py`` changes only in the JAX rule's four
  methods (``__init__``, ``configure``, ``_plan_for``,
  ``_sharded_plan_for``);
- ``env_docs``: every ``TORCHFT_*`` knob the port package,
  ``scripts/*_torch.py``, ``experiments/*_torch.py``,
  ``examples/train_ddp_torch.py``, ``bench_torch.py`` and
  ``bench_churn_torch.py`` read is in
  ``docs/OPERATIONS.md``.

(``capi_sync``'s port counterpart is ``tests/test_torch_capi_sync.py``.)

Usage::

    python scripts/graftlint_torch.py              # all three rules
    python scripts/graftlint_torch.py env_docs     # one rule
    python scripts/graftlint_torch.py --root PATH  # another checkout

Exits 0 when clean, 1 with one ``file:line: [rule] message`` per
violation otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path
from typing import Callable, Dict, List

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

from tools.graftlint import Violation  # noqa: E402
from tools.graftlint import cache_mutation, env_docs, latch_discipline  # noqa: E402

PORT = Path("torchft_tpu_torch")
MANAGER_PY = PORT / "manager.py"
PLANS_TARGET = {
    (str(PORT / "collectives.py"), "_plans"):
        cache_mutation.DEFAULT_TARGETS[("torchft_tpu/collectives.py", "_plans")],
}


def env_scan_files(root: Path) -> List[Path]:
    """The files whose ``TORCHFT_*`` reads ``env_docs`` holds to the docs,
    relative to ``root``."""
    files = sorted(p.relative_to(root) for p in (root / PORT).rglob("*.py"))
    files += sorted(p.relative_to(root)
                    for p in (root / "scripts").glob("*_torch.py"))
    files += sorted(p.relative_to(root)
                    for p in (root / "experiments").glob("*_torch.py"))
    return files + [Path("examples/train_ddp_torch.py"),
                    Path("bench_torch.py"), Path("bench_churn_torch.py")]


def check_env_docs(root: Path) -> List[Violation]:
    """``env_docs.check`` over :func:`env_scan_files`. The rule scans
    directories, so it runs on a view of them: a temporary directory of
    links to those files at their relative paths (violations name the
    same paths as in ``root``)."""
    with tempfile.TemporaryDirectory(prefix="graftlint_torch_") as view:
        for rel in env_scan_files(root):
            link = Path(view) / rel
            link.parent.mkdir(parents=True, exist_ok=True)
            os.symlink(root / rel, link)
        # the view holds only the scanned files: all of it is scanned
        return env_docs.check(Path(view), docs_path=root / env_docs.DOCS,
                              scan_dirs=[Path(".")])


RULES: Dict[str, Callable[[Path], List[Violation]]] = {
    "latch_discipline": lambda root: latch_discipline.check(
        root, manager_path=root / MANAGER_PY),
    "cache_mutation": lambda root: cache_mutation.check(root, PLANS_TARGET),
    "env_docs": check_env_docs,
}


def run(root: Path, rules: List[str] | None = None) -> List[Violation]:
    """The selected rules (default: all three) over ``root``'s port."""
    out: List[Violation] = []
    for name in rules or sorted(RULES):
        if name not in RULES:
            raise KeyError(f"unknown rule {name!r} (have: {sorted(RULES)})")
        out.extend(RULES[name](root))
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("rules", nargs="*",
                        help=f"rule names (default: all of {sorted(RULES)})")
    parser.add_argument("--root", type=Path, default=REPO_ROOT,
                        help="repository root to lint")
    args = parser.parse_args(argv)
    try:
        violations = run(args.root.resolve(), args.rules)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2
    for v in violations:
        print(v)
    if violations:
        print(f"graftlint_torch: {len(violations)} violation(s)",
              file=sys.stderr)
        return 1
    print("graftlint_torch: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Process-level helpers for hot spares: the standby gate and the
supervisor's warm-up and priority knobs.

The JAX package's backend pin and persistent compilation cache have no
counterpart here: the port's kernels and native library are built once,
under a lock, into ``_build/`` (:mod:`._build`), and a restarted process
loads the built files again.
"""

from __future__ import annotations

import os
import sys
import time


def standby_gate() -> None:
    """The hot spare's start line. When ``TORCHFT_STANDBY_FILE`` is set,
    the process is a pre-warmed standby: call this after imports and the
    warm-up (``HostCollectives.prewarm``, ``FTTrainState.warm``) but
    before creating the Manager (a standby joins no quorum), and it
    blocks until the supervisor creates the file. No-op otherwise.

    A cold restart pays the interpreter, the imports, the library loads
    and the first kernel launches before it can heal; a promoted standby
    has paid them already. On one GPU a standby warms on the primary's
    own card (each process holds its own CUDA context there), which a
    single-chip TPU host could not allow.

    Reaching the gate means the warm-up is complete, so a
    ``<path>.warm`` marker is touched on entry: the supervisor reads it
    to tell a warmed spare from one still importing. If the supervisor
    dies without promoting the standby, the standby exits rather than
    stay parked."""
    path = os.environ.get("TORCHFT_STANDBY_FILE")
    if not path:
        return
    try:
        open(path + ".warm", "w").close()
    except OSError:
        pass  # the marker is advisory; the gate works without it
    supervisor = os.getppid()
    while not os.path.exists(path):
        if os.getppid() != supervisor:
            sys.exit(0)  # orphaned: nobody is left to promote us
        time.sleep(0.05)


def standby_should_warm() -> bool:
    """Whether a standby runs the full warm-up before it parks (default
    yes, so promotion is a quorum join and a weight fetch);
    ``TORCHFT_STANDBY_WARM=0`` parks right after the imports."""
    return os.environ.get("TORCHFT_STANDBY_WARM", "1") != "0"


def standby_warm_deadline_s() -> float:
    """How long a supervisor lets a niced standby warm before it lifts
    it to normal priority (``TORCHFT_STANDBY_WARM_DEADLINE_S``, default
    20): on a saturated host an idle-priority warm-up can starve, and
    every later promotion would then find a half-warmed spare."""
    try:
        return float(os.environ.get("TORCHFT_STANDBY_WARM_DEADLINE_S", "20"))
    except ValueError:
        return 20.0


def heal_boost_nice() -> int:
    """The nice boost (``TORCHFT_HEAL_BOOST``, default 5; 0 disables) a
    privileged supervisor gives a cold-restarting worker while it heals,
    taken back after 60 s. Supervisors gate it on the same capability
    probe as standby renicing (``launcher._can_lift_priority``)."""
    try:
        return max(0, int(os.environ.get("TORCHFT_HEAL_BOOST", "5")))
    except ValueError:
        return 5

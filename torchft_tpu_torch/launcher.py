"""Replica-group launcher: one supervised process per replica group.

``replica_group_spec`` gives the command and environment of one group
for an external scheduler, and ``launch`` / the CLI supervise the
groups locally with restart on failure: the restart half of recovery
(the Manager heals). ``hot_spare=True`` keeps a pre-warmed standby per
group that a death promotes; ``regions`` adds an in-process region
lighthouse tier; ``root_addrs`` is the root failover set.

CLI::

    python -m torchft_tpu_torch.launcher --num-replica-groups 2 -- \
        python my_train.py
"""

from __future__ import annotations

import argparse
import logging
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

logger = logging.getLogger(__name__)


def replica_group_spec(
    cmd: Sequence[str],
    replica_group: int,
    num_replica_groups: int,
    lighthouse_addr: str,
    env: Optional[Dict[str, str]] = None,
    max_restarts: int = 10,
) -> Dict[str, object]:
    """Process spec for one replica group: command, env, and restart
    budget. The isolated data plane's knobs ride the spec when set, so an
    external scheduler (which does not inherit this environment) deploys
    every group with the same child-respawn discipline."""
    spec_env = {
        "TORCHFT_LIGHTHOUSE": lighthouse_addr,
        "REPLICA_GROUP_ID": str(replica_group),
        "NUM_REPLICA_GROUPS": str(num_replica_groups),
        **{knob: os.environ[knob]
           for knob in ("TORCHFT_ISO_ZYGOTE", "TORCHFT_ISO_LIVENESS_MS")
           if knob in os.environ},
        **(env or {}),
    }
    return {
        "name": f"replica_group_{replica_group}",
        "cmd": list(cmd),
        "env": spec_env,
        "max_restarts": max_restarts,
    }


def _can_lift_priority(
    status_text: Optional[str] = None, rlimit_nice: Optional[int] = None
) -> bool:
    """Whether this supervisor can LOWER a child's nice value later
    (promote a standby from nice 19 back to 0). Raising priority needs
    CAP_SYS_NICE or an RLIMIT_NICE allowance; setting nice is always
    allowed, which is exactly the trap: a supervisor that warms standbys
    at nice 19 but cannot lift a promoted one leaves it training at
    idle priority forever. Probed once at spawn time, so the decision is
    made before any standby is niced.

    The kernel's can_nice() check is CAPABILITY-based, so CapEff is the
    authority: euid 0 alone is NOT sufficient (a root process in a
    --cap-drop SYS_NICE container cannot lift either), and is only used
    as a fallback when /proc is unreadable. Parameterized for tests."""
    CAP_SYS_NICE = 23
    capeff: Optional[int] = None
    try:
        if status_text is None:
            with open("/proc/self/status") as f:
                status_text = f.read()
        for line in status_text.splitlines():
            if line.startswith("CapEff:"):
                capeff = int(line.split()[1], 16)
                break
    except (OSError, ValueError, IndexError):
        capeff = None
    if capeff is not None and capeff & (1 << CAP_SYS_NICE):
        return True
    try:
        if rlimit_nice is None:
            import resource

            rlimit_nice = resource.getrlimit(resource.RLIMIT_NICE)[0]
        # soft RLIMIT_NICE admits raising priority to 20 - rlim_cur;
        # RLIM_INFINITY reads as -1, i.e. unlimited allowance
        if rlimit_nice >= 20 or rlimit_nice < 0:
            return True
    except (ImportError, AttributeError, OSError, ValueError):
        pass
    if capeff is None:
        # No capability information (no /proc): fall back to euid.
        try:
            return os.geteuid() == 0
        except AttributeError:
            return False
    return False


@dataclass
class _Supervised:
    spec: Dict[str, object]
    proc: Optional[subprocess.Popen] = None
    restarts: int = 0
    returncode: Optional[int] = None
    standby: Optional[subprocess.Popen] = None
    standby_file: Optional[str] = None
    standby_armed_t: float = 0.0
    standby_lifted: bool = False
    boost_t: Optional[float] = None

    def standby_warm(self) -> bool:
        """Whether the parked standby finished its warm-up (it touches
        ``<standby_file>.warm`` when it reaches the gate)."""
        return bool(
            self.standby_file and os.path.exists(self.standby_file + ".warm")
        )


def launch(
    cmd: Sequence[str],
    num_replica_groups: int,
    lighthouse_addr: str,
    max_restarts: int = 10,
    env: Optional[Dict[str, str]] = None,
    hot_spare: bool = False,
    regions: int = 0,
    root_addrs: str = "",
) -> int:
    """Runs one process per replica group locally, restarting any that
    exits non-zero up to ``max_restarts`` times. Returns 0 iff every group
    eventually exited cleanly.

    ``hot_spare=True`` keeps one pre-warmed standby process per group: it
    runs the same command with ``TORCHFT_STANDBY_FILE`` set and parks at
    :func:`torchft_tpu_torch.platform.standby_gate` after its imports and
    warm-up. On a primary's death the supervisor promotes it by creating
    the file (one poll interval, against an interpreter start, the
    imports, the library loads and the first launches of a cold restart)
    and arms a fresh standby. The command must call ``standby_gate()``
    before it creates its Manager. On one GPU the standby warms on the
    primary's card, in a CUDA context of its own.

    ``regions > 0`` spawns ``regions`` in-process region lighthouses that
    aggregate into the root, with groups assigned round-robin. Each group
    gets its region as ``TORCHFT_LIGHTHOUSE``, the root set as
    ``TORCHFT_LIGHTHOUSE_ROOT`` (a region's death demotes its groups to
    the root) and its region label as ``TORCHFT_REGION``.

    ``root_addrs`` (default ``lighthouse_addr``) is the comma-separated
    root failover set, the active root and its warm standbys. The whole
    list rides ``TORCHFT_LIGHTHOUSE_ROOT`` into every group and into the
    region tier's upstream, so a root's death fails the fleet over to a
    standby without a relaunch."""
    import tempfile
    import uuid as _uuid

    standby_dir = tempfile.mkdtemp(prefix="torchft_standby_") if hot_spare else None
    root_addrs = root_addrs or os.environ.get(
        "TORCHFT_LIGHTHOUSE_ROOT", ""
    ) or lighthouse_addr
    region_tier = []
    if regions > 0:
        from . import _native

        for i in range(regions):
            region_tier.append(
                _native.RegionLighthouse(
                    root_addr=root_addrs, region_id=f"region_{i}"
                )
            )
        logger.info(
            f"region tier up: {[r.address() for r in region_tier]} -> root "
            f"{root_addrs}"
        )
    # Probe ONCE, at spawn time: standbys only warm at idle priority when
    # the supervisor can lift them back at promotion, and cold restarts
    # only get the heal-priority boost when the supervisor can set a
    # negative nice at all. Without the capability, warming un-niced
    # costs some contention during warm-up but a promoted worker trains
    # at full priority — the reverse trade (a permanently nice-19
    # primary) is never acceptable.
    lift_ok = _can_lift_priority()
    if hot_spare and not lift_ok:
        logger.warning(
            "hot-spare standbys warm at NORMAL priority: this supervisor "
            "cannot lift a niced child back to 0 (no CAP_SYS_NICE / root "
            "/ RLIMIT_NICE allowance), and a promoted worker must never "
            "keep training at nice 19"
        )
    groups = []
    for g in range(num_replica_groups):
        group_env = dict(env or {})
        group_lighthouse = lighthouse_addr
        if region_tier:
            group_lighthouse = region_tier[g % len(region_tier)].address()
            group_env.setdefault("TORCHFT_LIGHTHOUSE_ROOT", root_addrs)
            # The label the lighthouse tier is deployed by also labels
            # the data plane: it rides the quorum and, on a cohort of two
            # or more regions, selects the two-tier schedule.
            group_env.setdefault(
                "TORCHFT_REGION", f"region_{g % len(region_tier)}"
            )
        groups.append(
            _Supervised(
                replica_group_spec(
                    cmd, g, num_replica_groups, group_lighthouse, group_env,
                    max_restarts,
                )
            )
        )

    def spawn(s: _Supervised, as_standby: bool = False) -> subprocess.Popen:
        full_env = {**os.environ, **s.spec["env"]}  # type: ignore[arg-type]
        preexec = None
        if as_standby:
            assert standby_dir is not None
            s.standby_file = os.path.join(standby_dir, _uuid.uuid4().hex)
            full_env["TORCHFT_STANDBY_FILE"] = s.standby_file

            if lift_ok:

                def preexec() -> None:  # runs in the child pre-exec
                    # Standbys warm at idle priority, so re-arming after
                    # a promotion steals no cycles from live training.
                    # Gated on lift_ok: nicing is only safe when the
                    # promotion can undo it.
                    # (a refusal here leaves the standby at normal
                    # priority, the safe side; the child cannot log yet)
                    try:
                        os.nice(19)
                    except OSError:
                        pass
        else:
            full_env.pop("TORCHFT_STANDBY_FILE", None)
        proc = subprocess.Popen(
            list(s.spec["cmd"]), env=full_env, preexec_fn=preexec,  # type: ignore[arg-type]
        )
        role = "standby" if as_standby else "primary"
        logger.info(f"{s.spec['name']}: started {role} pid {proc.pid}")
        if as_standby:
            s.standby = proc
            s.standby_armed_t = time.monotonic()
            s.standby_lifted = False
        else:
            s.proc = proc
        return proc

    def promote_or_spawn(s: _Supervised) -> None:
        """Restart path: activate the warm standby when one is ready,
        else fall back to a cold spawn."""
        if s.standby is not None and s.standby.poll() is None:
            assert s.standby_file is not None
            if not s.standby_warm():
                # Promotion still beats a cold spawn (imports may be
                # partially done), but this is the signal the
                # warm-deadline policy below exists to eliminate.
                logger.warning(
                    f"{s.spec['name']}: promoting a standby that had NOT "
                    "finished warming — heal pays the remaining "
                    "import/compile at full priority"
                )
            open(s.standby_file, "w").close()  # releases standby_gate()
            s.proc = s.standby
            s.standby = None
            if lift_ok:
                # Promotion lifts the idle priority the standby warmed
                # at (the spawn-time probe guaranteed this works; when
                # it doesn't, the standby never warmed niced and there
                # is nothing to lift).
                try:
                    os.setpriority(os.PRIO_PROCESS, s.proc.pid, 0)
                except (OSError, AttributeError):
                    logger.warning(
                        f"{s.spec['name']}: could not lift standby "
                        "priority despite the spawn-time probe; promoted "
                        "worker may stay niced"
                    )
            logger.info(f"{s.spec['name']}: promoted standby pid {s.proc.pid}")
            spawn(s, as_standby=True)  # re-arm (idle priority again)
        else:
            spawn(s)
            if lift_ok and heal_boost:
                # Heal-priority boost (platform.heal_boost_nice): a COLD
                # restart is the cohort's degraded member — lend it
                # survivor CPU through its import+compile+heal, returned
                # by the timed de-boost in the supervise loop (the
                # launcher has no commit visibility, so the window is
                # time-bounded rather than commit-bounded).
                try:
                    os.setpriority(
                        os.PRIO_PROCESS, s.proc.pid, -heal_boost
                    )
                    s.boost_t = time.monotonic()
                except (OSError, AttributeError) as e:
                    logger.warning(
                        f"{s.spec['name']}: heal boost refused ({e!r}); "
                        "the restarted worker heals at normal priority")

    for s in groups:
        spawn(s)
        if hot_spare:
            spawn(s, as_standby=True)

    from .platform import heal_boost_nice, standby_warm_deadline_s

    warm_deadline = standby_warm_deadline_s()
    heal_boost = heal_boost_nice() if lift_ok else 0

    def lift_slow_warmups() -> None:
        """The re-arm fix: a niced standby that has not reached its warm
        marker within the grace window gets its priority restored so it
        FINISHES warming — otherwise, on a saturated host, every kill
        after the first promotes a half-warmed spare and pays the full
        import+compile on the heal critical path (round-3 root cause;
        the idle re-arm was keeping throughput at the cost of making
        repeat-kill heals cold). Bounded contention once per re-arm
        beats an unwarmed spare on every subsequent kill."""
        if not lift_ok:
            return  # standbys were never niced; nothing to lift
        now = time.monotonic()
        for s in groups:
            if (
                s.standby is None
                or s.standby.poll() is not None
                or s.standby_lifted
                or s.standby_warm()
                or now - s.standby_armed_t < warm_deadline
            ):
                continue
            s.standby_lifted = True
            try:
                os.setpriority(os.PRIO_PROCESS, s.standby.pid, 0)
                logger.warning(
                    f"{s.spec['name']}: standby still warming after "
                    f"{warm_deadline:.0f}s at idle priority; lifting it "
                    "so the next kill finds a fully-warmed spare"
                )
            except (OSError, AttributeError) as e:
                logger.warning(
                    f"{s.spec['name']}: could not lift a slow standby "
                    f"({e!r}); it keeps warming at idle priority")

    def deboost_healed() -> None:
        """Timed end of a heal boost: after the window a restarted worker
        is (long since) a committed peer again and must compete at
        parity. 60 s comfortably covers the measured cold heal; a worker
        that slow has bigger problems than priority."""
        now = time.monotonic()
        for s in groups:
            if s.boost_t is None or now - s.boost_t < 60:
                continue
            s.boost_t = None
            if s.proc is not None and s.proc.poll() is None:
                try:
                    os.setpriority(os.PRIO_PROCESS, s.proc.pid, 0)
                except (OSError, AttributeError) as e:
                    logger.warning(
                        f"{s.spec['name']}: could not end the heal boost "
                        f"({e!r})")

    try:
        while True:
            running = 0
            if hot_spare:
                lift_slow_warmups()
            if heal_boost:
                deboost_healed()
            for s in groups:
                if s.returncode is not None or s.proc is None:
                    continue
                rc = s.proc.poll()
                if rc is None:
                    running += 1
                elif rc == 0:
                    s.returncode = 0
                    logger.info(f"{s.spec['name']}: exited cleanly")
                elif s.restarts < int(s.spec["max_restarts"]):  # type: ignore[arg-type]
                    s.restarts += 1
                    logger.warning(
                        f"{s.spec['name']}: exited rc={rc}, restart "
                        f"{s.restarts}/{s.spec['max_restarts']}"
                    )
                    promote_or_spawn(s)
                    running += 1
                else:
                    s.returncode = rc
                    logger.error(
                        f"{s.spec['name']}: exhausted restarts (rc={rc}); "
                        "failing the job"
                    )
                    # A permanently failed group fails the whole job
                    # (torchelastic semantics): survivors could otherwise
                    # block forever in quorum waiting for it.
                    for other in groups:
                        if other.proc is not None and other.proc.poll() is None:
                            other.proc.terminate()
            if running == 0:
                break
            time.sleep(0.2)
    except KeyboardInterrupt:
        for s in groups:
            if s.proc is not None and s.proc.poll() is None:
                s.proc.terminate()
        raise
    finally:
        # Parked standbys never exit on their own, and the activation-file
        # directory is this invocation's to clean up.
        for s in groups:
            if s.standby is not None and s.standby.poll() is None:
                s.standby.kill()
        if standby_dir is not None:
            import shutil

            shutil.rmtree(standby_dir, ignore_errors=True)
        for region in region_tier:
            region.shutdown()
    return 0 if all(s.returncode == 0 for s in groups) else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="torchft_tpu_torch.launcher",
        description="Launch one supervised process per replica group.",
    )
    parser.add_argument("--num-replica-groups", type=int, default=2)
    parser.add_argument(
        "--lighthouse",
        default=os.environ.get("TORCHFT_LIGHTHOUSE", ""),
        help="lighthouse address; spawns an in-process one when omitted",
    )
    parser.add_argument("--max-restarts", type=int, default=10)
    parser.add_argument(
        "--regions",
        type=int,
        default=0,
        help="spawn N in-process region lighthouses aggregating into the "
        "(root) lighthouse; groups are assigned round-robin and fail over "
        "to the root when their region dies",
    )
    parser.add_argument(
        "--hot-spare",
        action="store_true",
        help="keep a pre-warmed standby per group; a dead primary is "
        "replaced by promotion (sub-second) instead of a cold restart. "
        "The command must call torchft_tpu_torch.platform.standby_gate() "
        "after "
        "warm-up, before creating its Manager.",
    )
    parser.add_argument("cmd", nargs="+", help="command to run per group")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    lighthouse = None
    lighthouse_addr = args.lighthouse
    if not lighthouse_addr:
        from . import _native

        lighthouse = _native.Lighthouse(bind="[::]:0", min_replicas=1)
        lighthouse_addr = lighthouse.address()
        logger.info(f"started lighthouse at {lighthouse_addr}")
    try:
        return launch(
            args.cmd,
            num_replica_groups=args.num_replica_groups,
            lighthouse_addr=lighthouse_addr,
            max_restarts=args.max_restarts,
            hot_spare=args.hot_spare,
            regions=args.regions,
        )
    finally:
        if lighthouse is not None:
            lighthouse.shutdown()


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (torchft_tpu_torch) on one GPU.

Drives the port's main paths — the per-step fault-tolerant training
transaction on the dense LM and on the flash-attention LM, flat, on the
two-tier schedule, on the legacy transport and as per-step ZeRO, the
window strategies (AsyncDiLoCo, sharded DiLoCo) and AdaptiveDDP, the
durable checkpoint tier, the weight-serving plane and the parameter
server, the durable control plane with the launcher's hot spares, the
chaos plane and the policy engine, and the second data plane (a torch
process group per quorum, in the trainer or in a disposable child) —
through the entry points a user calls, at full width (random weights
from a seed):
the transformer LM the repository benchmarks by default (vocab 8192,
d_model 512, 8 heads, 6 layers, d_ff 2048, sequence 512, batch 16: 39 f32
leaves, 23,337,472 parameters, dense attention), and bench.py's "big" LM
(vocab 8192, d_model 1024, 16 heads of 64, 8 layers, d_ff 4096, sequence
2048, batch 16: 51 f32 leaves, 111,166,464 parameters, use_flash=True):

1. build   the native control plane and the CUDA kernels from the sources
           in the checkout (in parallel, one nvcc per source); prints each
           kernel's registers and spills from ptxas (-Xptxas -v) and the
           dynamic shared memory a launch of it takes;
2. kernels every wire kernel (K1a q8 absmax, K1b q8 quantize, K2 q8
           decode, K3 bf16 cast) against its plain PyTorch version on the
           card, bit for bit, through one-segment tables at the dense
           path's 39 leaf shapes and special cases (ragged, all-zero, NaN,
           Inf, NaN bit patterns), and as the segmented launches over
           whole plan groups (the dense LM's 39 leaves, the flash LM's
           51, the specials with an empty leaf, views off the 16-byte
           grid, wire offsets off the vector grid, more leaves than one
           table holds, the dense group twice; K3 also over a mixed
           f32/bf16 group and its bit patterns, K2 on the codes and scales
           of a q8ef pack of each group and on NaN, Inf and subnormal
           scales); times each kernel over the dense group (K1a, K1b and
           K2 also over the flash group, K2 also as one launch per leaf),
           its plain version and the PyTorch library call where one
           exists, the eager time of one q8ef and one bf16 device pack of
           each group, and K3 in turns against ``x.to(torch.bfloat16)``
           and against the f32 concatenation then a flat cast;
3. flash   the flash-attention kernels (K4 forward, K5 backward: bf16 on
           the tensor-core kernels, wgmma with TMA loads, f32 on the
           scalar ones) against their plain versions on the card within
           printed tolerances: the big LM's call (16, 2047, 16, 64) bf16
           causal, S 2048, non-causal, windows 1/16/200/1000, block_k 32
           (the general path), head_dim 128 and f32 inputs; K5's folded
           delta against the torch one; K4 and K5 run twice must give the
           same bits; every bf16 kernel's SASS (cuobjdump) must hold HGMMA
           and UTMALDG instructions; times both (and K5's two kernels, dq
           with delta and dk/dv) at the big LM's call beside their bounds
           and achieved TFLOP/s, their plain versions and
           scaled_dot_product_attention's (timed only, never used by the
           port);
4. train   an in-process lighthouse and two replica-group worker processes
           sharing the GPU, each running Manager + HostCollectives +
           FTTrainState/AdamW + PipelinedDDP(compress="q8",
           transport="plan", device_pack=True), which gates every update
           on the commit vote: 2 warm-up steps (first quorum, ring, plan,
           staging), 4 timed steps, 2 steps under a torch.profiler trace
           of the card (group 0), then one step with compress="bf16";
5. heal    a third worker joins late, heals from a live peer through the
           CheckpointServer's streamed zero-copy path onto the card (the
           smoke fails on any other path), and all three train on;
6. flash train  two replica-group workers train the big LM with
           use_flash=True through the same PipelinedDDP(compress="q8")
           transaction: 2 warm-up steps, 3 timed steps, then 2 steps under
           a torch.profiler trace of the card (group 0), which must show
           the tensor-core flash kernels; group 0 first holds the flash
           loss against the dense loss on the same weights (forward only,
           batch 2);
7. hier flash train  the same two groups, both labeled with one host, on
           PipelinedDDP(compress="q8", transport="plan", hier=True): their
           sync rides the shared-memory host tier (one region: no inter
           hop, so no q8; the f32 average, a different schedule from the
           flat q8 ring, not a faster copy of it); 2 warm-up, 3 timed and
           2 traced steps;
8. hier dense  four groups on the dense LM in regions [r0, r0, r1, r1]
           on hosts [h0, h0, h1, h1]: the shm host tier and the
           inter-region ring (its q8ef wire) both run; 2 warm-up and 3
           steps;
9. legacy  two groups on the dense LM through PipelinedDDP(transport=
           "legacy") in every compress mode (None, bf16, q8, int8: 1
           warm-up, 2 pipelined and 1 blocking step each) beside the plan
           transport's q8 (1 + 2 steps), then broadcast and barrier across
           the two and the DummyCollectives fake on the card;
10. sharded flash  two groups on the big LM through
           ShardedOptimizerWrapper (ShardedDDP, shard_wire="q8",
           param_wire="bf16") on states built with opt_state=(): 2 warm-up
           and 3 steps, the optimizer state half of AdamW's per group;
11. sharded reshard  two dense groups on ShardedOptimizerWrapper, then a
           third joins: it heals the wrapper's state (the shard, its
           meta of Python ints) over the stream and every member
           re-partitions the optimizer state through the mask
           allgather;
12. heal transport  a donor process publishes one flash-LM group's state
           (111,166,464 f32 params + AdamW mu + nu on the card,
           1,333,997,568 B) and this process fetches it: the stream path
           on the raw and the bf16 wire (K3 narrows the moments in the
           donor), 1 and 4 streams each, the striped pickle (4) and the
           single stream; prints each fetch's fetch_s, h2d_s and bytes
           and holds every result against the donor's state: params bit
           for bit on every path, moments bit for bit on the raw wire and
           equal to K3's plain cast of the donor's on the bf16 wire;
13. remat  one forward+backward of the flash LM (B16, S2047, bf16) with
           remat off, full and save_attn on the same weights: time, peak
           memory, K4/K5 launches (8 / 16 / 8 and 16 each) and the
           gradients against remat off (bit for bit, or the difference
           printed within REMAT_GRAD_RTOL);
    experiments  the repository's experiments on the port, in one pooled
           (warm) process: every row of experiments/mfu_breakdown_torch.py
           (torch.matmul 8192^3 bf16 as the card's ceiling; the flash
           LM's make_train_step with AdamW, its gradients alone, its
           forward alone, the step with attention replaced by x @ wo and
           with the cross-entropy replaced by the mean logit; K4 + K5
           alone at the in-model shape) and experiments/
           flash_sweep_torch.py's attn rows at that shape (the plain
           version, the kernels at block_k 64 and 32, scaled_dot_product_
           attention forced to its flash backend), 1 warm-up and 3 timed
           calls a row (the matmul 32); every K4/K5 call, warm-up and
           timed, is held against its plain version between calls (the
           largest and the relative Frobenius difference) and each row's
           launches are checked (the no-attention step launches
           neither); prints each row with its launches and readings (the
           split by subtraction and the MFU come from the full scripts:
           at this depth they are noise);
    bench  bench_torch.py's phases at fixed depth, in this process, each
           ring peer (a zero-contributing replica group) a pooled process
           on the host CPU: a raw window at bench's dense model; one
           PipelinedDDP(compress="int8", transport="legacy") ring session
           at bench's ddp_small LM (S 2048, flash), whose first two
           steps' int8 payloads (K1a/K1b, K2) and member-wise averages
           (K2) are held bit for bit against the plain path and whose
           K4/K5 calls are held by experiments/common_torch.PlainCheck;
           one blocking and one pipelined f32 session at the dense
           model; one _DilocoHarness window on the bf16 wire, its warm
           syncs' K3 casts held bit for bit; checks a ring of 2 with 2
           participants, every step committed, finite params;
    churn  bench_churn_torch.py --dryrun as a user runs it (group 0 on the
           card, group 1 on the host CPU, TORCHFT_HEAL_WIRE=bf16: healthy,
           churn and hot-spare phases of 48 steps, SIGKILLs of group 1 and
           heals from group 0, which narrows its moments with K3 for each
           heal it serves); checks churn_dryrun_ok, a stream heal on the
           bf16 wire in each churn phase (in the hot-spare one by a
           promoted spare) and group 0's launches (K3 alone); then run_durable_phase in this process on the card (1M
           elements, 2 checkpoints, W 3 -> 2): K3's exact launches
           (durable_k3_launches), every member restored bit-identical,
           its w bit for bit the saved one and its moments K3's plain
           version of the saved ones; then --durable --dryrun as a user
           runs it;
14. async diloco flash  two groups on the big LM on a synchronous-quorum
           manager: inner steps make_train_step(AdamW, bf16_params=True)
           + step_applied(), outer AsyncDiLoCo(SGD(0.7, momentum=0.9,
           nesterov=True)), sync_every 4, in each of compress="bf16"
           (overlap), "int8" (no overlap) and "q8" (overlap): 1 warm and
           1 timed window each; prints per mode the inner step p50, each
           sync's launch and finish ms, the window time per inner step
           and its ratio to the bare inner step (no manager) timed in the
           same workers;
15. sharded diloco  the same two groups on DiLoCo(sharded=True,
           shard_wire="q8", param_wire="bf16"), 1 window of 4: each
           sync's ms and its reduce_scatter / allgather_into split, the
           outer momentum (222,332,928 B per group at W = 2);
16. diloco reshard  two dense groups on sharded DiLoCo (sync_every 2),
           then a third joins: it heals in its first start_quorum and
           takes part in that sync, where all three re-partition the
           outer state;
17. adaptive flash  two flash groups on AdaptiveDDP(compress="q8",
           probe_steps=2) with TORCHFT_DEVICE_PACK=auto, an explicit
           TORCHFT_HOST and TORCHFT_DDP_SHARDED=1: six candidates
           (blocking, plan on the host pack of the card leaves,
           plan_devpack, plan_hier over the shm tier, pipelined,
           ddp_sharded), 12 probe steps after the anchor, 1 locked;
           prints decision["probe_s"] and the locked mode;
18. durable flash  two groups on the big LM (PipelinedDDP(q8) blocking
           steps) with DurableCheckpointer(mode="async", wire="bf16",
           every 2, keep 2, register_hook=True) into one LocalDirStore
           for 4 committed steps (captures at 2 and 4, each group writing
           its half of the 889 MB stream; K3 narrows the AdamW moments),
           then one mode="sync" capture each (the stall baseline); a fresh
           group with a new replica id then cold-restores at width 1
           through the manager's durable consult at its first quorum:
           params bit-identical to the saved step, moments equal to K3 of
           the saved ones; prints each capture's stall_s, write_s,
           commit_s and bytes, and the restore's seconds;
19. serving flash  a training group (this process) publishes its params
           through publish_on_commit, 2 versions per wire (q8, bf16,
           f32; snapshot_every 4): the encode on the card (K1a/K1b, K3)
           and the q8 decode (K2) of the served tree; a WeightRelay and
           two subscribers behind it, a third on the publisher, all
           installing on the card (K2 for q8); every install's digest,
           the served tree bit for bit, no torn install; prints per
           version the publish split (encode on the card, d2h, CRC,
           digest), the relay's sync, each install's fetch / decode /
           digest ms and bytes;
20. parameter server  a session over the ring sends the big LM's
           largest leaf (on the card) from server to client and back,
           bit-identical; a subscriber of serving_address() installs one
           q8 version of the LM;
21. control dense  two dense groups through launcher.launch with hot
           spares, two in-process region lighthouses and a root failover
           set of two RootProcesses (an active root with a WAL, a standby
           with --standby --peers); the workers are this script re-run
           with --control-worker on PipelinedDDP(q8) blocking steps; each
           spare runs HostCollectives.prewarm and FTTrainState.warm on the
           card and parks at standby_gate(). Group 1's primary is
           SIGKILLed at step CONTROL_KILL_STEP: its spare is promoted and
           heals over the stream on the bf16 wire (K3 in the donor); then
           the active root is SIGKILLed and the fleet fails over to the
           standby root. Group 0 is never killed. The same two groups then
           run cold (restart only, the raw heal wire) with the same kill.
           Prints
           kill-to-first-commit seconds (promoted, cold), the heals'
           fetch_s / h2d_s, the takeover and failover seconds, and each
           spare's warm-up seconds, launches and memory;
22. chaos flash  two flash groups (the big LM, depth cut to 2 layers)
           on PipelinedDDP(q8) blocking steps with
           TORCHFT_WIRE_CRC=1 under a seeded FaultPlan (ring_send
           bit_flip, duplicate, drop, delay, truncate and ring_hdr
           bit_flip, one each at attempted steps 1-6), armed each step
           in each worker's own fault engine; then a SIGKILL of group 1
           and its restart, healing through a HealFaultProxy that
           truncates one stream range of the donor (the fallback must
           carry it). Prints the seed and plan, the faults injected and
           detected, the steps discarded and the recovery times;
23. policy flash  two flash groups (2 layers, as in chaos flash) on a
           sync-quorum manager under
           PolicyEngine: ddp_plan (q8) against sharded diloco_q8_h4
           (outer SGD(0.7, 0.9, Nesterov)), a decision every 4 steps,
           CostKnobs(sync_fixed_s=0.5); prints each decision's costs and
           signals, the switch tick and each decision transaction's
           seconds;
    chaos harness  beside phases 22 and 23 (their card work leaves the
           host room), scripts/chaos_run_torch.py --dryrun --tree
           dense (members' trees the dense LM's 39 leaves on the
           card: the plan and hier_shm schedules, the pinned bit flip,
           a root outage with a WAL'd primary and a standby, the sharded
           re-partition, a whole-fleet loss restored from the durable
           tier, serving churn, the iso child's SIGKILL and SIGSTOP) and
           one plan schedule on the q8 wire (K1a/K1b), two processes at
           once; checks a CRC detection, 0 silent commits, epoch purity,
           bit identity and liveness on every schedule, a root restart
           that replayed its WAL, a re-partition, a fleet-loss restore
           equal to the pre-kill digest, and K1a/K1b/K2 launches; prints
           each schedule's seconds and faults, the takeover and
           kill-to-next-commit seconds;
24. nccl probe  two processes build one XLACollectives(backend="nccl")
           group over the one card; prints the verdict or the refusal's
           text (the next phase runs on NCCL only if it was accepted);
25. xla dense  two dense groups with the in-process XLACollectives
           (gloo) as the Manager's plane on PipelinedDDP(transport=
           "legacy", compress="q8") blocking steps, its allreduce,
           allgather and broadcast on card tensors, whether the gloo
           group takes a card tensor itself, then a third group joins
           and heals; every configure leaves the params' bits as they
           were;
26. iso flash  two flash groups with Manager(iso_collectives=
           IsolatedXLACollectives) on PipelinedDDP(transport="iso",
           compress="q8") blocking steps: 1 warm-up, 3 timed, then group
           1's child SIGKILLed mid-op (both groups discard, the next
           quorum respawns it, 2 steps), then SIGSTOPped (the stall
           verdict, 1 step); prints the op split (pack, d2h, ring,
           child_s, h2d, bytes), kill -> ChildDiedError, kill -> next
           commit, dispatch -> ChildStalledError and each configure's
           split; every op must take the psum path;
27. adaptive dense  two dense groups on AdaptiveDDP(compress="q8") with
           an isolated plane: blocking, plan, plan_devpack, pipelined and
           xla_iso race, 2 probe steps each, 1 locked;
28. parallel  one launch of four rank processes (two replica groups of
           two ranks, gloo meshes on the one card; each rank a
           Manager(rank=r, world_size=2) and PipelinedDDP(compress="q8")
           blocking steps over parallel.build_grad_step) runs the model-
           parallel sub-phases at full width: cnn (CNNConfig(), groups of
           one rank), cp ulysses and cp ring (the big LM, depth cut to 2
           layers, over {"seq": 2}),
           pp flash ({"pipe": 2}, 4 microbatches), ep moe (MoEConfig()
           over {"expert": 2}) and tp flash ({"model": 2}), whose group 1
           is SIGKILLed after its timed steps and restarted from other
           weights, each rank healing its shard from group 0's; each
           sub-phase holds its step-0 loss within 3e-3 of the unsharded
           loss, commits every step with the groups' params equal rank
           for rank, and launches its kernels; prints step times, the
           intra-group collectives' ms and MB, each rank's ring, peak
           memory, kill -> first commit, and which gloo ops take a card
           tensor handed to them (probed in throwaway processes);
29. quickstart  examples/train_ddp_torch.py as a user runs it: the
           lighthouse CLI (its dashboard and /status.json read back),
           then MODEL=lm under python -m torchft_tpu_torch.launcher
           --num-replica-groups 2 --hot-spare (400 steps, a durable
           snapshot every 100, the bf16 heal wire) with group 1's primary
           SIGKILLed at its step 100, and at the same time mlp, cnn and
           moe as one-group fleets; then group 0 restarted alone on the
           durable directory (its process started beside the fleet and
           parked at the trainer's standby gate until the fleet ended).
           Every trainer starts cold and runs through
           scripts/train_record_torch.py, which records its launches,
           commits, the states it served and healed into, and its final
           params; checks the promoted spare healed from group 0 on the
           stream path, every heal left the state its peer served
           (params bit for bit, moments rounded to bf16), K3 bit for bit
           against its plain version on the opt_state leaves that heal
           staged, both groups end at NUM_STEPS with equal
           batches_committed and params within
           _bf16_heal_drift_bound, the restart restored the last
           snapshot, every side fleet committed its steps and K3
           launched; prints kill -> first commit of the promoted spare,
           the heal's path and bytes, K3's launches, each model's step
           p50 and a fresh process's seconds to its first commit.

The train, flash train and hier phases drain Manager.observe_op_stats()
around their timed steps and print, per cell, the native per-bucket
pack_s / ring_s / unpack_s split (summed over a step's buckets and
their largest), each stripe's ring seconds, the byte bill (wire_bytes,
d2h_bytes), the port's pack / d2h / ring split, on the two-tier
schedule the tiers (shm_rs_s, shm_ag_s, shm_bytes, the inter tier's
bytes), and signals()["wire_eff_MBps"] / ["tier_eff_MBps"].

Checks: every step commits (in the reshard phase all but the first
three-member step, which the joiner's heal discards by design); every
loss is finite; each worker's kernel
launch counts equal plan groups x q8 steps (K1a, K1b: one group, one
launch each per step; on the legacy q8 and int8 modes also K2 once per
step, and on int8 once more per member per settle), groups x bf16 steps
(K3), layers x forward/backward passes (K4) and 2 x layers x passes (K5;
a pass per step, and one more for a step whose gradients a heal made
stale), and 0 for every other kernel — the counts are reset to 0 in each worker just before it
drives a path and read just after; all groups end bit-identical, the
healed one included (the sharded groups after every step), and the
heals took the stream path; the sharded groups' shards tile the model. The window
phases check that every sync commits (the diloco joiner's first too),
that the groups' backups are bit-identical after every AsyncDiLoCo sync
and the params after every sharded DiLoCo sync (under overlap=False
the params within each group's error-feedback change of the backup),
the outer momentum's size, and exact launches: per sync K3 once (bf16;
and the sharded param leg), K1a/K1b/K2 once (int8/q8, the sharded
delta), K2 once more per member (int8), K4/K5 per inner step. The
adaptive phase checks that both groups race the same six candidates,
none fails, both lock one mode and end bit-identical. The hier phases also check that every group is
hier-capable with the expected host-tier transport ("shm"; "tcp" under
TORCHFT_HC_SHM=0), that no wire kernel launched (the two-tier pack is
native), that the hier plan allocated no staging after warm-up, and in
the hier dense cell that each region leader's inter tier sent about one
byte per parameter per step (the q8 wire, not the f32 size) and no
other group sent any. Prints one ``kernels`` JSON line (each kernel's
launches in total and by phase; K3 must launch in the heal transport
phase, K1a/K1b/K2/K3 in the legacy, async diloco flash, sharded diloco
and diloco reshard phases, K4/K5 in the sharded flash, async diloco
flash, sharded diloco and adaptive flash phases, K1a/K1b/K2 in the
adaptive flash phase; K3 in the durable flash phase, K1a/K1b/K2/K3 in
the serving flash phase, K1a/K1b/K2 in the parameter server phase,
with exact counts; K1a/K1b/K3 in the control dense phase, K1a/K1b/K4/K5
in the chaos flash phase and K1a/K1b/K2/K4/K5 in the policy flash
phase; K1a/K1b/K2 in the xla dense and adaptive dense phases,
K1a/K1b/K2/K4/K5 in the iso flash phase, K3 in the quickstart phase,
K4/K5 in the experiments phase, all six in the bench phase, K3 in the
churn phase (group 0's) and in the churn durable run (exact)).
The control dense phase checks that quorum ids only go up,
that every heal took the stream path to a state the other group served
(bit for bit), that the cold run ends bit-identical and the hot run
(whose bf16 heal wire rounds the AdamW moments) within the drift that
rounding allows (_bf16_heal_drift_bound), that the standby root took
over, and that each spare's prewarm launched the q8 pack. The chaos
flash phase checks the four invariants: quorum epochs never go back, the
groups' params agree at every step both commit and at the end, every
corrupting fault's attempt commits on neither member and its receiver
raises WireCorruption there, and commits follow the last fault and the
restart (whose heal must fall back off the stream path). The policy
flash phase checks that both members took identical decisions, at least
one a committed switch, and end bit-identical. The card's name and
power limit, a ``phase_s`` JSON line (each phase's seconds), and as its
last line ``{"ok": true, "device": {...}}``.
Any failed phase exits non-zero.

Usage: ``python3 chip_smoke.py`` (needs one CUDA device; the workers are
this script re-run with ``--worker``, the heal donor with
``--heal-donor``). ``python3 chip_smoke.py
--flash-turns`` measures only: the flat q8 and the hier flash phases in
turns (flat, hier, hier, flat), one JSON line per turn; ``--shm-probe``
checks only that the machine's /dev/shm takes the shm host tier;
``--window-phases`` builds and runs only phases 14-17,
``--serving-phases`` only phases 18-20, ``--control-phases`` only
phases 21-23 (the launched workers are this script re-run with
``--control-worker``), ``--harness-phases`` only the chaos harness,
``--iso-phases`` only phases 24-27,
``--parallel-phases`` only phase 28, ``--quickstart-phases`` only
phase 29, ``--bench-phases`` the bench phase, then bench_torch.py in
full as a user runs it (BENCH_ATTEMPT_TIMEOUT_S=1000; every phase must
be measured, none errored or skipped) and the three experiments that
import it (ddp_phase_breakdown_torch.py, ddp_modes_torch.py,
ddp_small_tpu_breakdown_torch.py), ``--churn-phases`` the churn phase,
then bench_churn_torch.py in full on the card (4 groups, 1200 steps, a
kill every 100, hot spares) and --durable, each with measurement_ok,
``--experiments-phases`` the experiments phase, then the four
experiments/*_torch.py in full (flash_sweep in both modes, every
ablation mode), each alone on the card, then experiments/
verify_e2e_torch.sh on the card; ``--legacy-turns A B`` runs the
legacy and sharded flash phases of checkouts A and B in turns (a, b, b,
a), each from its own chip_smoke.py and build; ``--kernel-turns A B``
likewise the flash kernel phase (phase 3), K4's and K5's times compared
at the end.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import hashlib
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
LM = dict(vocab_size=8192, d_model=512, n_heads=8, n_layers=6, d_ff=2048,
          max_seq_len=512)
BATCH, SEQ = 16, 512
WARM_STEPS = 2         # untimed q8 steps: first quorum, ring, plan, staging
Q8_STEPS = 4           # timed PipelinedDDP(q8) steps of the train phase
TRACED_STEPS = 2       # q8 steps under the profiler (not timed)
TRACED_FLASH_STEPS = 2  # flash steps under the profiler (not timed)
HEAL_STEPS = 2         # steps all three groups take after the late join
# bench.py's "big" LM (bench.py:131-147) on its flash path
BIG_LM = dict(vocab_size=8192, d_model=1024, n_heads=16, n_layers=8,
              d_ff=4096, max_seq_len=2048, use_flash=True)
BIG_BATCH, BIG_SEQ = 16, 2048
FLASH_STEPS = 3        # timed flash steps, after WARM_STEPS untimed ones
HIER_HOST = "smoke_host"  # the host label both hier flash groups carry
# hier dense: (region, host) of each of its four groups
HIER_DENSE_LABELS = [("r0", "h0"), ("r0", "h0"), ("r1", "h1"), ("r1", "h1")]
HIER_DENSE_STEPS = 3   # steps after WARM_STEPS untimed ones
# legacy phase: the compress modes of PipelinedDDP(transport="legacy"),
# each 1 warm-up and LEGACY_STEPS timed pipelined steps then a blocking one
LEGACY_MODES = (None, "bf16", "q8", "int8")
LEGACY_STEPS = 2
# sharded flash phase: ShardedDDP(shard_wire="q8") steps on the big LM
SHARDED_WARM, SHARDED_STEPS = 2, 3
# the big LM's full AdamW state (mu + nu, f32): what ZeRO halves at W = 2
FLASH_ADAMW_BYTES = 2 * 4 * 111_166_464
# sharded reshard phase: founder steps before the late joiner, and steps
# all three take after the first three-member quorum
RESHARD_STEPS = 3
# async diloco flash: AsyncDiLoCo's modes (compress, overlap): bench.py's
# two link-dependent choices (bench.py:1158-1168) and the q8 ring; each
# DILOCO_WARM_WINDOWS untimed and DILOCO_WINDOWS timed windows of
# DILOCO_SYNC_EVERY inner steps, beside RAW_STEPS bare inner steps
DILOCO_MODES = (("bf16", True), ("int8", False), ("q8", True))
DILOCO_SYNC_EVERY = 4
DILOCO_WARM_WINDOWS, DILOCO_WINDOWS = 1, 1
RAW_STEPS = 4
# sharded diloco: windows on the big LM; the outer Nesterov momentum is
# half of the big LM's f32 size per group at W = 2
SHARDED_DILOCO_WINDOWS = 1
SHARDED_OUTER_BYTES = 4 * 111_166_464 // 2
# diloco reshard (dense LM, sync_every 2): founder windows before the
# joiner, and windows all three take after the first three-member quorum
DILOCO_RESHARD_WINDOWS = 2
# adaptive flash: probe steps per candidate, steps after the lock
ADAPTIVE_PROBE_STEPS = 2
ADAPTIVE_LOCKED_STEPS = 1
ADAPTIVE_HOST = "smoke_host"  # an explicit TORCHFT_HOST: plan_hier races
# the big LM's attention call: (B, S, H, head_dim), S = 2048 less the
# token loss_fn drops
FLASH_SHAPE = (BIG_BATCH, BIG_SEQ - 1, 16, 64)
# flash vs dense loss on the same weights, bf16 compute: two bf16 steps
# (2**-7) relative. The paths round attention probabilities to bf16 at
# different points (dense: normalised, flash: against each tile's
# running max), a fraction of a bf16 step per output element.
FLASH_DENSE_LOSS_RTOL = 2.0 ** -7
# H100 SXM (NVIDIA data sheet): HBM3 rate, dense bf16 tensor-core and
# f32 (non-tensor) peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# K3 against its library call: rounds, and graph replays of each per round
K3_ROUNDS, K3_REPLAYS = 3, 200
KERNEL_SOURCES = {
    "q8_absmax": "torchft_tpu_torch/csrc/quantize_kernels.cu",
    "q8_quantize": "torchft_tpu_torch/csrc/quantize_kernels.cu",
    "q8_dequantize": "torchft_tpu_torch/csrc/quantize_kernels.cu",
    "cast_bf16": "torchft_tpu_torch/csrc/quantize_kernels.cu",
    "flash_fwd": "torchft_tpu_torch/csrc/flash_attention.cu",
    "flash_bwd": "torchft_tpu_torch/csrc/flash_attention.cu",
}
PACK_KERNELS = ("q8_absmax_seg_kernel", "q8_quantize_seg_kernel",
                "cast_bf16_seg_kernel")
# the flash kernels' names in a trace (both families), and the tensor-core
# kernels the bf16 path runs (the forward and both backward kernels on
# wgmma with TMA)
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
MMA_KERNELS = ("flash_fwd_wgmma_kernel", "flash_bwd_dkdv_wgmma_kernel",
               "flash_bwd_dq_wgmma_kernel")
# the bf16 kernels' route, and the SASS instructions that show it: the
# warpgroup products and the TMA tile loads
MMA_ROUTE = "wgmma"
MMA_SASS = ("HGMMA", "UTMALDG")
# the bf16 instantiations the library must hold, by kernel: the forward
# and dq per (D, block_k), dk/dv per D (its key tile is 64 whatever
# block_k is)
MMA_INSTANCES = {
    "flash_fwd_wgmma_kernel": ("<D64, BN64>", "<D64, BN32>", "<D128, BN64>",
                               "<D128, BN32>"),
    "flash_bwd_dq_wgmma_kernel": ("<D64, BN64>", "<D64, BN32>",
                                  "<D128, BN64>", "<D128, BN32>"),
    "flash_bwd_dkdv_wgmma_kernel": ("<D64>", "<D128>"),
}
TRACE_FILE = "trace_g0.json"
REPLACES = {
    "q8_absmax": "torchft_tpu/ops/quantize_kernels.py:109",
    "q8_quantize": "torchft_tpu/ops/quantize_kernels.py:175",
    "q8_dequantize": "torchft_tpu/ops/quantize_kernels.py:253",
    "cast_bf16": "torchft_tpu/ops/quantize_kernels.py:281",
    "flash_fwd": "torchft_tpu/ops/flash_attention.py:261",
    "flash_bwd": "torchft_tpu/ops/flash_attention.py:382",
}


def log(msg: str) -> None:
    print(msg, flush=True)


# when this process started its work (a pooled spare: when it got it)
T_WORK = time.perf_counter()


def _mark(marks: dict, name: str) -> None:
    """Seconds from the start of this process's work to ``name``."""
    marks[name] = round(time.perf_counter() - T_WORK, 3)


# (phase, start on the host clock): each phase's seconds for the phase_s line
PHASE_MARKS: list = []


def _phase(name: str) -> None:
    """Logs the start of a phase and marks its time."""
    PHASE_MARKS.append((name, time.perf_counter()))
    log(f"phase {name}")


# phases that ran beside the marked ones: their own seconds
PHASES_BESIDE: dict = {}


def _phase_seconds() -> dict:
    """Each marked phase's seconds: to the next mark, the last to now;
    then each phase that ran beside them, its own seconds (so these do
    not add up to the total)."""
    marks = PHASE_MARKS + [("end", time.perf_counter())]
    return {**{a: round(t1 - t0, 1)
               for (a, t0), (_, t1) in zip(marks, marks[1:])},
            **PHASES_BESIDE}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# -- worker: one replica group --------------------------------------------------


def _tokens(cfg: dict, step: int, device: torch.device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(1000 * cfg["group"] + step)
    return torch.randint(0, cfg["lm"]["vocab_size"], (cfg["batch"], cfg["seq"]),
                         generator=gen).to(device)


def _digest(params) -> str:
    from torchft_tpu_torch._tree import flatten

    h = hashlib.sha256()
    for p in flatten(params)[0]:
        h.update(p.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _timer_means_ms(before: dict, after: dict) -> dict:
    """Mean ms of each transaction timer (quorum, plan_allreduce from
    dispatch to result, commit_vote, reconfigure, heal_fetch) over the
    samples taken between two snapshots, with the largest seen so far."""
    means = {}
    for name, a in after.items():
        if name.endswith("MBps"):  # throughputs observe_op_stats records
            continue
        b = before.get(name, {"n": 0, "total_s": 0.0})
        n = a["n"] - b["n"]
        if n > 0:
            means[name] = {"n": n, "mean": round(
                1e3 * (a["total_s"] - b.get("total_s", 0.0)) / n, 3),
                "max_so_far": round(1e3 * a["max"], 3)}
    return means


def _intervals_ms(events) -> list:
    return sorted((e["ts"] / 1e3, (e["ts"] + e["dur"]) / 1e3) for e in events)


def _union_ms(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _trace_summary(path: str) -> dict:
    """Where the ring ran against the card's work, from a torch.profiler
    chrome trace of PipelinedDDP steps. On the card's clock each step's
    ring window opens when the packer stream's (on the two-tier schedule:
    the plan's staging stream's) last device-to-host copy of that step
    ends (the native ring starts on the staged bytes) and
    closes when the first host-to-device upload of its result starts.
    Reports, per step, the window and how much of the loop stream's
    kernel time (the next step's forward/backward) ran inside it; the
    loop stream's and the packer stream's kernel time over the trace; and
    the card's busy share (this process's work) over the traced span."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                  "gpu_memset") and "dur" in e]
    if not dev:
        return {"device_events": 0}
    stream = lambda e: e.get("args", {}).get("stream")
    pack_streams = {stream(e) for e in dev
                    if e["cat"] == "kernel"
                    and any(k in e["name"] for k in PACK_KERNELS)}
    if not pack_streams:  # the two-tier plan: its staging stream's copies
        pack_streams = {stream(e) for e in dev if e["cat"] == "gpu_memcpy"
                        and "DtoH" in e["name"] and "Pinned" in e["name"]}
    d2h = _intervals_ms(e for e in dev if e["cat"] == "gpu_memcpy"
                        and stream(e) in pack_streams and "DtoH" in e["name"])
    # the result's uploads come from pinned staging, the tokens' do not
    h2d = _intervals_ms(e for e in dev if e["cat"] == "gpu_memcpy"
                        and stream(e) not in pack_streams
                        and "HtoD" in e["name"] and "Pageable" not in e["name"])
    loop_kernels = _intervals_ms(e for e in dev if e["cat"] == "kernel"
                                 and stream(e) not in pack_streams)
    pack_kernels = _intervals_ms(e for e in dev if e["cat"] == "kernel"
                                 and stream(e) in pack_streams)
    windows = []
    for i, (_, d2h_end) in enumerate(d2h):
        if i + 1 < len(d2h) and d2h[i + 1][0] - d2h_end < 1.0:
            continue  # the payload and scale copies of one step: take the last
        starts = [a for a, _ in h2d if a > d2h_end]
        if starts:
            windows.append((d2h_end, starts[0]))
    inside = [sum(max(0.0, min(b, w1) - max(a, w0)) for a, b in loop_kernels)
              for w0, w1 in windows]
    span = (min(a for a, _ in _intervals_ms(dev)),
            max(b for _, b in _intervals_ms(dev)))
    return {
        "device_events": len(dev),
        "pack_streams": sorted(map(str, pack_streams)),
        "ring_windows_ms": [round(w1 - w0, 3) for w0, w1 in windows],
        "loop_kernel_ms_inside_ring": [round(x, 3) for x in inside],
        "loop_kernel_ms_total": round(sum(b - a for a, b in loop_kernels), 3),
        "pack_kernel_ms_total": round(sum(b - a for a, b in pack_kernels), 3),
        "traced_ms": round(span[1] - span[0], 3),
        "card_busy_share": round(_union_ms(_intervals_ms(dev))
                                 / (span[1] - span[0]), 4),
        "flash_kernel_ms_total": round(sum(
            e["dur"] for e in dev if e["cat"] == "kernel"
            and any(k in e["name"] for k in FLASH_KERNELS)) / 1e3, 3),
        "flash_kernels": _top_kernels(
            [e for e in dev if any(k in e["name"] for k in FLASH_KERNELS)]),
        "top_kernels": _top_kernels(dev),
    }


def _top_kernels(dev, top: int = 6) -> list:
    """The kernels that took the most device time in the trace, by name."""
    by_name: dict = {}
    for e in dev:
        if e["cat"] == "kernel":
            n, ms = by_name.get(e["name"], (0, 0.0))
            by_name[e["name"]] = (n + 1, ms + e["dur"] / 1e3)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return [{"name": name[:90], "n": n, "ms": round(ms, 3)}
            for name, (n, ms) in ranked]


def _op_stats_rows(entries) -> list:
    """One row per plan_allreduce (one per step) of the drained op stats:
    the native per-bucket pack_s / ring_s / unpack_s summed over the
    step's buckets and their largest, the ring seconds of each stripe
    (over the stripe's buckets), the byte bill, the port's own
    pack / d2h / ring split, and on the two-tier schedule the tiers."""
    rows = []
    for st in entries:
        if st.get("op") != "plan_allreduce":
            continue
        b = st.get("buckets") or []
        row = {k: st.get(k) for k in ("bytes", "wire_bytes", "d2h_bytes",
                                      "pack", "d2h", "ring")}
        row["buckets"] = len(b)
        for key in ("pack_s", "ring_s", "unpack_s"):
            vals = [x[key] for x in b]
            row[f"{key}_sum"] = sum(vals)
            row[f"{key}_max"] = max(vals, default=0.0)
        stripes: dict = {}
        for x in b:
            stripes[x["stripe"]] = stripes.get(x["stripe"], 0.0) + x["ring_s"]
        row["stripe_s"] = [stripes[k] for k in sorted(stripes)]
        if st.get("hier"):
            tiers = st.get("tiers", {})
            row.update({k: st.get(k) for k in (
                "shm_rs_s", "shm_ag_s", "shm_bcast_s", "inter_ring_s",
                "py_staging_allocs")})
            row["shm_bytes"] = tiers.get("host", {}).get("shm_bytes")
            row["host_transport"] = tiers.get("host", {}).get("transport")
            row["inter_tx_bytes"] = tiers.get("inter", {}).get("tx_bytes")
            row["inter_leader"] = tiers.get("inter", {}).get("leader")
            row["inter_world"] = tiers.get("inter", {}).get("world")
        rows.append(row)
    return rows


def _median(xs):
    xs = sorted(x for x in xs if x is not None)
    return xs[len(xs) // 2] if xs else None


def _ring_split(rows) -> dict:
    """The median over a phase's steps of each op-stats field: seconds as
    ms (``ring_s_sum`` -> ``ring_sum_ms``), bytes as recorded."""
    out: dict = {"steps": len(rows)}
    for key in ("pack_s_sum", "pack_s_max", "ring_s_sum", "ring_s_max",
                "unpack_s_sum", "unpack_s_max", "pack", "d2h", "ring",
                "shm_rs_s", "shm_ag_s", "shm_bcast_s", "inter_ring_s"):
        v = _median([r.get(key) for r in rows])
        if v is not None:
            name = key[:-2] if key.endswith("_s") else key.replace("_s_", "_")
            out[f"{name}_ms"] = round(1e3 * v, 3)
    for key in ("bytes", "wire_bytes", "d2h_bytes", "buckets", "shm_bytes",
                "inter_tx_bytes", "py_staging_allocs"):
        v = _median([r.get(key) for r in rows])
        if v is not None:
            out[key] = v
    stripes = list(zip(*[r["stripe_s"] for r in rows if r["stripe_s"]]))
    out["stripe_ms"] = [round(1e3 * _median(x), 3) for x in stripes]
    return out


def _wait_for(path: str, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"gate {path} never opened")
        time.sleep(0.05)


def _flash_vs_dense(model_cfg, params, cfg: dict, device: torch.device) -> dict:
    """The flash path's loss and the dense path's on the same weights and
    tokens, forward only, at batch 2 (the dense path's f32 (S, S) scores
    are then 0.5 GB a layer)."""
    import dataclasses

    from torchft_tpu_torch.models import transformer as tt

    tokens = _tokens({**cfg, "batch": 2}, 10**6 + 1, device)
    dense_cfg = dataclasses.replace(model_cfg, use_flash=False)
    with torch.no_grad():
        return {"flash": float(tt.loss_fn(model_cfg, params, tokens)),
                "dense": float(tt.loss_fn(dense_cfg, params, tokens))}


def worker(cfg: dict) -> None:
    os.environ.update(cfg.get("env", {}))
    if cfg["role"] in ("sharded_flash", "reshard", "reshard_late"):
        sharded_worker(cfg)
        return
    if cfg["role"] in ("diloco_flash", "diloco_reshard",
                       "diloco_reshard_late"):
        diloco_worker(cfg)
        return
    if cfg["role"] == "adaptive_flash":
        adaptive_worker(cfg)
        return
    if cfg["role"] == "durable_flash":
        durable_worker(cfg)
        return
    if cfg["role"] == "chaos":
        chaos_worker(cfg)
        return
    if cfg["role"] == "policy":
        policy_worker(cfg)
        return
    if cfg["role"] == "iso_flash":
        iso_worker(cfg)
        return
    if cfg["role"] in ("xla_dense", "xla_dense_late"):
        xla_worker(cfg)
        return
    if cfg["role"] == "nccl_probe":
        nccl_probe_worker(cfg)
        return
    if cfg["role"] == "adaptive_iso":
        adaptive_iso_worker(cfg)
        return
    if cfg["role"] == "parallel":
        parallel_worker(cfg)
        return
    if cfg["role"] == "gloo_probe":
        gloo_probe_worker(cfg)
        return
    if cfg["role"] == "experiments":
        experiments_worker(cfg)
        return
    import torchft_tpu_torch as tft
    from torchft_tpu_torch.models import transformer as tt
    from torchft_tpu_torch.ops import quantize_kernels as qk

    g, workdir = cfg["group"], cfg["workdir"]
    marks: dict = {}
    _mark(marks, "imports")
    device = torch.device(cfg["device"])
    on_card = device.type == "cuda"
    model_cfg = tt.TransformerConfig(**cfg["lm"])
    model = tt.TransformerLM(model_cfg, seed=0, device=device)
    state = tft.FTTrainState(model.params(), tft.AdamW(1e-3, weight_decay=1e-4))
    model_grad_fn = tt.make_grad_fn(model_cfg)
    grad_calls = [0]  # forward/backward passes: steps plus heal recomputes

    def grad_fn(params, tokens):
        grad_calls[0] += 1
        return model_grad_fn(params, tokens)

    out = {"group": g, "phases": {}, "marks": marks}
    _mark(marks, "model")
    if cfg["role"] == "flash" and g == 0:
        out["flash_vs_dense"] = _flash_vs_dense(model_cfg, state.params, cfg,
                                                device)
        _mark(marks, "flash_vs_dense")
    # Warm up before joining (library init, allocator), and time the
    # forward/backward alone: a step's compute, against which the
    # transaction's overhead is read. Both founders run this at once, so
    # it sees the same sharing of the card as their steps.
    warm = _tokens(cfg, 10**6, device)
    compute_s = []
    for _ in range(4):
        t0 = time.perf_counter()
        grad_fn(state.params, warm)
        if on_card:
            torch.cuda.synchronize()
        compute_s.append(time.perf_counter() - t0)
    _mark(marks, "compute")
    collectives = tft.HostCollectives()
    manager = tft.Manager(
        collectives=collectives, load_state_dict=state.load_state_dict,
        state_dict=state.state_dict, min_replica_size=cfg.get("groups", 2),
        rank=0, world_size=1, lighthouse_addr=cfg["lighthouse"],
        replica_id=f"g{g}", region=cfg.get("region"),
        host_label=cfg.get("host"), device=device,
    )
    _mark(marks, "manager")
    out["compute_s"] = sorted(compute_s[1:])[1]
    n_layers = len(state.params["blocks"])
    n_leaves = n_layers * 6 + 3

    def run(phase: str, compress: str, more, trace: bool = False,
            hier: bool = False, transport: str = "plan",
            blocking: int = 0) -> None:
        """PipelinedDDP steps while ``more(i, committed_step)``, then
        ``blocking`` blocking steps (the first settles the pipelined one in
        flight), then a flush that settles whatever is left. A step's time
        ends when the loop's own stream has drained (not the whole card:
        the packer's stream and the ring may still run, as in training).
        The data plane's op stats are drained just before and just
        after."""
        ddp = tft.PipelinedDDP(manager, state, grad_fn, compress=compress,
                               transport=transport, device_pack=True,
                               hier=hier)
        manager.observe_op_stats()
        prof = None
        if trace and on_card:  # the card's activity only: little host cost
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        before = manager.metrics().snapshot()
        calls_before = grad_calls[0]
        qk.reset_launch_counts()
        losses, commits, dispatches, step_s, mem_start = [], [], 0, [], []
        t_start = t_prev = time.perf_counter()
        i = 0
        while more(i, manager.current_step()):
            if on_card:  # what the pipelined steps before this one hold
                mem_start.append(torch.cuda.memory_allocated(device))
            losses.append(ddp.step(_tokens(cfg, cfg["data_offset"] + i, device)))
            i += 1
            dispatches += 1
            if ddp.last_commit is not None and dispatches > 1:
                commits.append(ddp.last_commit)
            if on_card:
                torch.cuda.current_stream().synchronize()
            now = time.perf_counter()
            step_s.append(now - t_prev)
            t_prev = now
        commits.append(ddp.flush())
        t_prev = time.perf_counter()
        blocking_s = []
        for _ in range(blocking):
            losses.append(ddp.blocking_step(
                _tokens(cfg, cfg["data_offset"] + i, device)))
            i += 1
            dispatches += 1
            commits.append(ddp.last_commit)
            if on_card:
                torch.cuda.current_stream().synchronize()
            now = time.perf_counter()
            blocking_s.append(now - t_prev)
            t_prev = now
        if on_card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t_start
        launches = dict(qk.launch_counts)
        drained = manager.observe_op_stats()
        op_stats = _op_stats_rows(drained)
        grad_passes = grad_calls[0] - calls_before
        _mark(marks, phase)
        if prof:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(workdir, TRACE_FILE))
            _mark(marks, f"{phase}_export")
            out["trace"] = _trace_summary(os.path.join(workdir, TRACE_FILE))
            _mark(marks, f"{phase}_summary")
        cfg["data_offset"] += i
        out["phases"][phase] = {
            "dispatches": dispatches,
            "commits": commits,
            "losses": [float(l) for l in losses],
            "launches": launches,
            "grad_passes": grad_passes,
            "step_s": step_s,
            "blocking_s": blocking_s,
            "mem_start": mem_start,
            "window_s": window_s,
            "timers_ms": _timer_means_ms(
                before["timers_s"], manager.metrics().snapshot()["timers_s"]),
            "heals": {k: v - before["counters"].get(k, 0) for k, v in
                      manager.metrics().snapshot()["counters"].items()
                      if "heals" in k},
            "step": manager.current_step(),
            "digest": _digest(state.params),
            "op_stats": op_stats,
            "op_split": _op_split(drained),
            "signals": manager.signals(),
        }

    joined: dict = {}

    def until_healed_and_on(i: int, step: int) -> bool:
        """Train until HEAL_STEPS steps after the first three-member quorum.
        Its step is the same on every member: the founders' committed step
        when it formed, the max_step the late group healed to."""
        if "at" not in joined and collectives.size() == 3:
            joined["at"] = step
        return "at" not in joined or step < joined["at"] + HEAL_STEPS

    try:
        if cfg["role"] == "late":
            # heartbeating from construction: the next quorum waits for us
            open(os.path.join(workdir, "late_up"), "w").close()
            run("heal", "q8", until_healed_and_on)
            out["heals"] = manager.metrics().snapshot()["counters"].get("heals", 0)
            out["fetch"] = manager.checkpoint_transport().last_fetch_stats
        elif cfg["role"] in ("flash", "hier_flash"):
            hier = cfg["role"] == "hier_flash"
            run("warm", "q8", lambda i, step: i < WARM_STEPS, hier=hier)
            run("flash", "q8", lambda i, step: i < FLASH_STEPS, hier=hier)
            run("traced", "q8", lambda i, step: i < TRACED_FLASH_STEPS,
                trace=g == 0, hier=hier)
        elif cfg["role"] == "legacy":
            # the plan transport's q8 beside the legacy modes, same run
            run("plan_warm", "q8", lambda i, step: i < 1)
            run("plan_q8", "q8", lambda i, step: i < LEGACY_STEPS)
            for mode in LEGACY_MODES:
                name = mode or "f32"
                run(f"{name}_warm", mode, lambda i, step: i < 1,
                    transport="legacy")
                run(name, mode, lambda i, step: i < LEGACY_STEPS,
                    transport="legacy", blocking=1)
            out["plane_ops"] = _plane_ops(collectives, g, device)
        elif cfg["role"] == "hier_dense":
            run("warm", "q8", lambda i, step: i < WARM_STEPS, hier=True)
            run("hier", "q8", lambda i, step: i < HIER_DENSE_STEPS, hier=True)
        else:
            run("warm", "q8", lambda i, step: i < WARM_STEPS)
            run("q8", "q8", lambda i, step: i < Q8_STEPS)
            run("traced", "q8", lambda i, step: i < TRACED_STEPS,
                trace=g == 0)
            run("bf16", "bf16", lambda i, step: i < 1)
            open(os.path.join(workdir, f"ready_{g}"), "w").close()
            _wait_for(os.path.join(workdir, "late_up"), 300)
            run("heal", "q8", until_healed_and_on)
        out["n_leaves"], out["n_layers"] = n_leaves, n_layers
        out["topology"] = {
            "hier_capable": manager.hier_capable(),
            "host_tier_transport": collectives.host_tier_transport(),
            "regions": manager.replica_regions(),
            "hosts": manager.replica_hosts()}
        if on_card:
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    finally:
        manager.shutdown()
        _mark(marks, "manager_down")
        collectives.shutdown()
        _mark(marks, "collectives_down")
    with open(os.path.join(workdir, f"result_{g}.json"), "w") as f:
        json.dump(out, f)


def sharded_worker(cfg: dict) -> None:
    """Per-step ZeRO through ``ShardedOptimizerWrapper`` (the
    ``zero_grad(); grads; step(grads)`` loop over ``ShardedDDP``) on a
    state built with ``opt_state=()``; the manager's state callbacks are
    the wrapper's, so a heal carries the optimizer shard and its meta.
    Roles: ``sharded_flash`` (the big LM, SHARDED_WARM then SHARDED_STEPS
    steps), ``reshard`` (a founder on the dense LM: steps, then on with
    the late joiner) and ``reshard_late`` (the joiner)."""
    import torchft_tpu_torch as tft
    from torchft_tpu_torch._tree import flatten
    from torchft_tpu_torch.models import transformer as tt
    from torchft_tpu_torch.ops import quantize_kernels as qk

    g, workdir = cfg["group"], cfg["workdir"]
    device = torch.device(cfg["device"])
    on_card = device.type == "cuda"
    model_cfg = tt.TransformerConfig(**cfg["lm"])
    model = tt.TransformerLM(model_cfg, seed=0, device=device)
    state = tft.FTTrainState(model.params(),
                             tft.AdamW(1e-3, weight_decay=1e-4), opt_state=())
    grad_fn = tt.make_grad_fn(model_cfg)
    holder: dict = {}
    collectives = tft.HostCollectives()
    manager = tft.Manager(
        collectives=collectives,
        load_state_dict=lambda sd: holder["opt"].load_state_dict(sd),
        state_dict=lambda: holder["opt"].state_dict(),
        min_replica_size=cfg.get("groups", 2), rank=0, world_size=1,
        lighthouse_addr=cfg["lighthouse"], replica_id=f"g{g}", device=device,
    )
    opt = holder["opt"] = tft.ShardedOptimizerWrapper(
        manager, state, shard_wire=cfg["shard_wire"])
    out: dict = {"group": g, "phases": {},
                 "n_layers": len(state.params["blocks"]),
                 "total": sum(p.numel() for p in
                              flatten(state.params)[0])}
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    def run(phase: str, more) -> None:
        manager.observe_op_stats()
        before = manager.metrics().snapshot()
        qk.reset_launch_counts()
        commits, losses, step_s, digests = [], [], [], []
        i = 0
        while more(i, manager.current_step()):
            t0 = time.perf_counter()
            opt.zero_grad()
            loss, grads = grad_fn(state.params,
                                  _tokens(cfg, cfg["data_offset"] + i, device))
            commits.append(opt.step(grads))
            if on_card:
                torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss))
            digests.append(_digest(state.params))  # not in the step's time
            i += 1
        cfg["data_offset"] += i
        meta = opt._core._shard_meta
        shard = opt._core._opt_shard
        out["phases"][phase] = {
            "dispatches": i, "commits": commits, "losses": losses,
            "step_s": step_s, "digests": digests,
            "launches": dict(qk.launch_counts),
            "op_split": _op_split(manager.observe_op_stats()),
            "opt_state_bytes": opt.opt_state_bytes(),
            "opt_numel": None if shard is None else shard["mu"].numel(),
            "ranges": None if meta is None else
            [list(r) for r in meta["ranges"]["float32"]],
            "quorum_id": None if meta is None else meta["quorum_id"],
            "world": collectives.size(),
            "heals": {k: v - before["counters"].get(k, 0) for k, v in
                      manager.metrics().snapshot()["counters"].items()
                      if "heals" in k},
            "timers_ms": _timer_means_ms(
                before["timers_s"], manager.metrics().snapshot()["timers_s"]),
            "step": manager.current_step(),
        }

    joined: dict = {}

    def until_joined_and_on(i: int, step: int) -> bool:
        """Steps until RESHARD_STEPS after the first three-member quorum
        (whose step is the same on every member)."""
        if "at" not in joined and collectives.size() == 3:
            joined["at"] = step
        return "at" not in joined or step < joined["at"] + RESHARD_STEPS

    try:
        if cfg["role"] == "sharded_flash":
            run("warm", lambda i, step: i < SHARDED_WARM)
            run("sharded", lambda i, step: i < SHARDED_STEPS)
        elif cfg["role"] == "reshard":
            run("founders", lambda i, step: i < SHARDED_WARM)
            open(os.path.join(workdir, f"ready_{g}"), "w").close()
            _wait_for(os.path.join(workdir, "late_up"), 300)
            run("join", until_joined_and_on)
        else:
            open(os.path.join(workdir, "late_up"), "w").close()
            run("join", until_joined_and_on)
            out["fetch"] = manager.checkpoint_transport().last_fetch_stats
        if on_card:
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    finally:
        manager.shutdown()
        collectives.shutdown()
    with open(os.path.join(workdir, f"result_{g}.json"), "w") as f:
        json.dump(out, f)


def _max_abs(tree) -> float:
    from torchft_tpu_torch._tree import flatten

    return max(float(l.detach().abs().max()) for l in flatten(tree)[0])


def diloco_worker(cfg: dict) -> None:
    """The window strategies on a sync-quorum manager. Roles:
    ``diloco_flash`` (the big LM: bare inner steps, then AsyncDiLoCo in
    each of DILOCO_MODES, then sharded DiLoCo), ``diloco_reshard`` (a
    founder on the dense LM: sharded DiLoCo windows, then on with the
    late joiner) and ``diloco_reshard_late`` (the joiner, which heals in
    its first start_quorum and takes part in that sync). Inner steps are
    ``make_train_step(AdamW, bf16_params=True)`` and ``step_applied()``;
    the outer optimizer is ``SGD(0.7, momentum=0.9, nesterov=True)``."""
    import torchft_tpu_torch as tft
    from torchft_tpu_torch._tree import flatten, tree_map
    from torchft_tpu_torch.models import transformer as tt
    from torchft_tpu_torch.ops import quantize_kernels as qk

    g, workdir, role = cfg["group"], cfg["workdir"], cfg["role"]
    device = torch.device(cfg["device"])
    on_card = device.type == "cuda"
    model_cfg = tt.TransformerConfig(**cfg["lm"])
    state = tft.FTTrainState(tt.init_params(model_cfg, seed=0, device=device),
                             tft.AdamW(1e-3, weight_decay=1e-4))
    train_step = tt.make_train_step(model_cfg, state.tx, bf16_params=True)
    out: dict = {"group": g, "n_layers": model_cfg.n_layers, "phases": {},
                 "total": sum(p.numel() for p in flatten(state.params)[0])}

    def card_sync() -> None:
        if on_card:
            torch.cuda.synchronize(device)

    def inner(i: int) -> None:
        train_step(state.params, state.opt_state,
                   _tokens(cfg, cfg["data_offset"] + i, device))

    holder: dict = {}
    collectives = tft.HostCollectives()
    manager = tft.Manager(
        collectives=collectives,
        load_state_dict=lambda sd: holder["e"].load_state_dict(sd),
        state_dict=lambda: holder["e"].state_dict(),
        min_replica_size=cfg.get("groups", 2), rank=0, world_size=1,
        lighthouse_addr=cfg["lighthouse"], replica_id=f"g{g}", device=device,
        use_async_quorum=False,
    )
    outer = lambda: tft.SGD(0.7, momentum=0.9, nesterov=True)  # noqa: E731
    # seconds the smoke's own checks (the digests of 445 MB of params)
    # took inside a step: billed to no step or window
    overhead = [0.0]

    def instrument(eng, rec: dict) -> None:
        """Times each sync's launch and finish (card work included, the
        inner steps queued before it excluded) and records every
        committed sync's backup and params digests."""
        rec.update(launch_s=[], finish_s=[], commits=[], backups=[],
                   params=[], residual_max=[])
        finish, launch = eng._finish_pending, getattr(eng, "_launch_sync",
                                                      None)

        def timed_finish() -> None:
            if eng._pending is None:
                return
            card_sync()
            t0 = time.perf_counter()
            finish()
            card_sync()
            t1 = time.perf_counter()
            rec["finish_s"].append(t1 - t0)
            rec["commits"].append(eng.last_sync_commit)
            rec["backups"].append(_digest(eng._backup_params))
            rec["params"].append(_digest(state.params))
            if eng._residual is not None:
                rec["residual_max"].append(_max_abs(eng._residual))
            if not eng._overlap:
                # θ − G' after a synchronous sync: the EF residual's
                # change, per group (never bit-identical across groups)
                rec.setdefault("theta_dev", []).append(max(
                    float((a - b).abs().max()) for a, b in zip(
                        flatten(state.params)[0],
                        flatten(eng._backup_params)[0])))
                rec["theta_max"] = _max_abs(state.params)
            overhead[0] += time.perf_counter() - t1

        def timed_launch() -> None:
            card_sync()
            t0 = time.perf_counter()
            launch()
            card_sync()
            rec["launch_s"].append(time.perf_counter() - t0)

        eng._finish_pending = timed_finish
        if launch is not None:
            eng._launch_sync = timed_launch

    def windows(eng, n: int, step_s: list) -> None:
        for i in range(n * DILOCO_SYNC_EVERY):
            o0, t0 = overhead[0], time.perf_counter()
            inner(i)
            eng.step_applied()
            card_sync()
            step_s.append(time.perf_counter() - t0 - (overhead[0] - o0))
        cfg["data_offset"] += n * DILOCO_SYNC_EVERY

    try:
        if role == "diloco_flash":
            for compress, overlap in DILOCO_MODES:
                eng = holder["e"] = tft.AsyncDiLoCo(
                    manager, state, outer(), DILOCO_SYNC_EVERY,
                    compress=compress, overlap=overlap)
                rec: dict = {"compress": compress, "overlap": overlap}
                instrument(eng, rec)
                before = manager.metrics().snapshot()
                qk.reset_launch_counts()
                warm_s: list = []
                windows(eng, DILOCO_WARM_WINDOWS, warm_s)
                step_s: list = []
                o0, t0 = overhead[0], time.perf_counter()
                windows(eng, DILOCO_WINDOWS, step_s)
                eng.flush()
                card_sync()
                rec["window_s"] = (time.perf_counter() - t0
                                   - (overhead[0] - o0))
                rec["launches"] = dict(qk.launch_counts)
                rec["step_s"], rec["warm_step_s"] = step_s, warm_s
                rec["inner_steps"] = len(warm_s) + len(step_s)
                rec["timers_ms"] = _timer_means_ms(
                    before["timers_s"], manager.metrics().snapshot()["timers_s"])
                out["phases"][f"async_{compress}"] = rec
                # the next mode starts at the cohort's agreed params
                eng._restore_parameters()
            # sharded DiLoCo on the same cohort
            eng = holder["e"] = tft.DiLoCo(
                manager, state, outer(), DILOCO_SYNC_EVERY, sharded=True,
                shard_wire="q8", param_wire="bf16")
            rec = {"sync_s": [], "digests": [], "commits": []}
            sync = eng._perform_sync

            def timed_sync() -> None:
                card_sync()
                t0 = time.perf_counter()
                sync()
                card_sync()
                t1 = time.perf_counter()
                rec["sync_s"].append(t1 - t0)
                rec["commits"].append(eng.last_sync_commit)
                rec["digests"].append(_digest(state.params))
                overhead[0] += time.perf_counter() - t1

            eng._perform_sync = timed_sync
            manager.observe_op_stats()
            qk.reset_launch_counts()
            step_s = []
            windows(eng, SHARDED_DILOCO_WINDOWS, step_s)
            rec["launches"] = dict(qk.launch_counts)
            rec["step_s"] = step_s
            rec["inner_steps"] = len(step_s)
            rec["op_split"] = _op_split(manager.observe_op_stats())
            rec["outer_bytes"] = sum(l.numel() * l.element_size() for l in
                                     flatten(eng._outer_state)[0])
            rec["ranges"] = [list(r) for r in
                             eng._outer_shard_meta["ranges"]["float32"]]
            out["phases"]["sharded"] = rec
            # bare inner steps (no manager, no window), both groups at once
            # as in the windows (the last sync left them in step), on
            # copies of the state
            p = tree_map(lambda l: l.clone(), state.params)
            o = tree_map(lambda l: l.clone() if isinstance(l, torch.Tensor)
                         else l, state.opt_state)
            raw = []
            for i in range(RAW_STEPS):
                t0 = time.perf_counter()
                train_step(p, o, _tokens(cfg, 10**6 + i, device))
                card_sync()
                raw.append(time.perf_counter() - t0)
            out["raw_step_s"] = raw[1:]
            del p, o
        else:
            eng = holder["e"] = tft.DiLoCo(
                manager, state, outer(), 2, sharded=True, shard_wire="q8",
                param_wire="bf16")
            rec = {"commits": [], "digests": [], "world": []}
            sync = eng._perform_sync

            def logged_sync() -> None:
                sync()
                rec["commits"].append(eng.last_sync_commit)
                rec["digests"].append(_digest(state.params))
                rec["world"].append(collectives.size())

            eng._perform_sync = logged_sync
            qk.reset_launch_counts()
            if role == "diloco_reshard":
                for i in range(DILOCO_RESHARD_WINDOWS * 2):
                    inner(i)
                    eng.step_applied()
                cfg["data_offset"] += DILOCO_RESHARD_WINDOWS * 2
                open(os.path.join(workdir, f"ready_{g}"), "w").close()
                _wait_for(os.path.join(workdir, "late_up"), 300)
            else:
                open(os.path.join(workdir, "late_up"), "w").close()
            i = 0
            while rec["world"].count(3) < DILOCO_RESHARD_WINDOWS:
                inner(i)
                eng.step_applied()
                i += 1
            card_sync()
            rec["launches"] = dict(qk.launch_counts)
            meta = eng._outer_shard_meta
            rec["ranges"] = [list(r) for r in meta["ranges"]["float32"]]
            rec["quorum_id"] = meta["quorum_id"]
            rec["outer_numel"] = flatten(eng._outer_state)[0][0].numel()
            counters = manager.metrics().snapshot()["counters"]
            rec["heals"] = {k: v for k, v in counters.items() if "heals" in k}
            rec["fetch"] = manager.checkpoint_transport().last_fetch_stats
            out["phases"]["reshard"] = rec
        if on_card:
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                device)
    finally:
        manager.shutdown()
        collectives.shutdown()
    with open(os.path.join(workdir, f"result_{g}.json"), "w") as f:
        json.dump(out, f)


def adaptive_worker(cfg: dict) -> None:
    """AdaptiveDDP(compress="q8") on the big LM: 6 candidates (blocking,
    plan with the host pack of the card leaves, plan_devpack, plan_hier
    over the shm host tier, pipelined, ddp_sharded), ADAPTIVE_PROBE_STEPS
    each after the anchor step, then ADAPTIVE_LOCKED_STEPS in the locked
    mode. The env (TORCHFT_DEVICE_PACK=auto, TORCHFT_HOST,
    TORCHFT_DDP_SHARDED=1) comes with the worker's config."""
    import torchft_tpu_torch as tft
    from torchft_tpu_torch.models import transformer as tt
    from torchft_tpu_torch.ops import quantize_kernels as qk

    g, workdir = cfg["group"], cfg["workdir"]
    device = torch.device(cfg["device"])
    on_card = device.type == "cuda"
    model_cfg = tt.TransformerConfig(**cfg["lm"])
    model = tt.TransformerLM(model_cfg, seed=0, device=device)
    state = tft.FTTrainState(model.params(), tft.AdamW(1e-3, weight_decay=1e-4))
    model_grad_fn = tt.make_grad_fn(model_cfg)
    grad_calls = [0]

    def grad_fn(params, tokens):
        grad_calls[0] += 1
        return model_grad_fn(params, tokens)

    collectives = tft.HostCollectives()
    manager = tft.Manager(
        collectives=collectives, load_state_dict=state.load_state_dict,
        state_dict=state.state_dict, min_replica_size=cfg.get("groups", 2),
        rank=0, world_size=1, lighthouse_addr=cfg["lighthouse"],
        replica_id=f"g{g}", device=device, use_async_quorum=False,
    )
    ddp = tft.AdaptiveDDP(manager, state, grad_fn, compress="q8",
                          probe_steps=ADAPTIVE_PROBE_STEPS)
    out: dict = {"group": g, "n_layers": model_cfg.n_layers,
                 "candidates": list(ddp._candidates)}
    try:
        qk.reset_launch_counts()
        steps = 1 + ADAPTIVE_PROBE_STEPS * len(ddp._candidates) \
            + ADAPTIVE_LOCKED_STEPS
        modes, step_s, losses = [], [], []
        for i in range(steps):
            modes.append(ddp.mode)
            t0 = time.perf_counter()
            losses.append(float(ddp.step(_tokens(cfg, i, device))))
            if on_card:
                torch.cuda.synchronize(device)
            step_s.append(time.perf_counter() - t0)
        out["flush"] = ddp.flush()
        out.update(launches=dict(qk.launch_counts), grad_passes=grad_calls[0],
                   decision=ddp.decision, mode=ddp.mode, modes=modes,
                   step_s=step_s, losses=losses,
                   digest=_digest(state.params), steps=steps,
                   committed=manager.current_step(),
                   topology={"hier_capable": manager.hier_capable(),
                             "host_tier_transport":
                             collectives.host_tier_transport()})
        if on_card:
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                device)
    finally:
        manager.shutdown()
        collectives.shutdown()
    with open(os.path.join(workdir, f"result_{g}.json"), "w") as f:
        json.dump(out, f)


def _op_split(entries) -> dict:
    """Per op name of the drained op stats (the legacy and sharded ops):
    the count and the median of each phase second (as ms) and byte
    field."""
    out: dict = {}
    for name in sorted({st.get("op") for st in entries} - {None}):
        sts = [st for st in entries if st.get("op") == name]
        row: dict = {"n": len(sts)}
        for key in ("pack", "d2h", "host_copy", "ring", "h2d"):
            v = _median([st.get(key) for st in sts])
            if v is not None:
                row[f"{key}_ms"] = round(1e3 * v, 3)
        for key in ("bytes", "wire_bytes", "d2h_bytes", "shard_bytes",
                    "chunks"):
            v = _median([st.get(key) for st in sts])
            if v is not None:
                row[key] = v
        out[name] = row
    return out


def _plane_ops(collectives, g: int, device: torch.device) -> dict:
    """broadcast and barrier across the groups' ring, and the
    DummyCollectives fake's ops on the card: what each group saw."""
    import torchft_tpu_torch as tft

    x = {"x": torch.full((4096,), float(g), device=device)}
    got = collectives.broadcast(x, root=0).wait()
    collectives.barrier().wait()
    d = tft.DummyCollectives(rank=0, world_size=2)
    half = d.allreduce(x, divisor=2.0).wait()["x"]
    dummy_ok = (torch.equal(half, x["x"] / 2)
                and d.allgather(x).wait() == [x, x]
                and d.broadcast(x).wait() is x and d.barrier().wait() is None
                and d.op_count == 4)
    return {"rank": collectives.rank(), "sent": float(g),
            "broadcast": float(got["x"][0]),
            "broadcast_uniform": bool((got["x"] == got["x"][0]).all()),
            "broadcast_on_device": got["x"].device.type == device.type,
            "dummy_ok": bool(dummy_ok)}


# -- parent phases ---------------------------------------------------------------


def phase_build() -> dict:
    from torchft_tpu_torch import _build

    t0 = time.perf_counter()
    errors = []
    times = {}

    def run(name, fn):
        t = time.perf_counter()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - reported below, then fatal
            errors.append(f"{name}: {e}")
        times[name] = time.perf_counter() - t

    threads = [threading.Thread(target=run, args=a) for a in
               (("native", _build.build_native), ("kernels", _build.build_kernels))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail("build: " + "; ".join(errors))
    for row in _ptxas_report(os.path.join(_build.BUILD_DIR, "kernels_build.log")):
        log(f"  ptxas {row['name']}: {row.get('registers')} registers, "
            f"spills {row.get('spill_stores')} B stored / "
            f"{row.get('spill_loads')} B loaded"
            + (f", {row['smem']} B dynamic shared memory" if "smem" in row else ""))
    times["total"] = time.perf_counter() - t0
    return times


def _ptxas_report(path: str) -> list:
    """Each kernel's registers and spill bytes from nvcc's ``-Xptxas -v``
    log, and for the flash kernels the dynamic shared memory one launch
    takes (which ptxas does not see), as the library reports it."""
    from torchft_tpu_torch import _build
    from torchft_tpu_torch.ops._lib import _kernels

    kinds = {"fwd": 0, "dkdv": 1, "dq": 2}
    names = []  # the kernels the sources declare
    for src in _build.KERNEL_SOURCES:
        with open(src) as f:
            names += re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?"
                                r"(\w+)\(", f.read())
    rows = []
    with open(path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                # mangled: the name follows its length
                name = next((n for n in names if f"{len(n)}{n}" in m.group(1)),
                            m.group(1))
                shape = _template_args(m.group(1))
                row = {"name": name}
                if name.startswith("flash_") and shape:
                    d, bn = shape
                    row["name"] = name + _instance_key(d, bn)
                    kind = kinds[name.split("_")[2 if "bwd" in name else 1]]
                    bf16 = "_wgmma_" in name
                    row["smem"] = _kernels.lib().tft_flash_smem_bytes(
                        kind, 1 if bf16 else 0, d, bn or 64)
                rows.append(row)
            elif rows:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                              line)
                if m:
                    rows[-1]["spill_stores"], rows[-1]["spill_loads"] = map(
                        int, m.groups())
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    rows[-1]["registers"] = int(m.group(1))
    return rows


def _template_args(mangled: str):
    """(D, BN) of a flash kernel's mangled name, BN None for the one
    template argument of dk/dv; None if it has none."""
    m = re.search(r"ILi(\d+)E(?:Li(\d+)E)?E", mangled)
    if not m:
        return None
    return int(m.group(1)), int(m.group(2)) if m.group(2) else None


def _instance_key(d: int, bn) -> str:
    return f"<D{d}, BN{bn}>" if bn else f"<D{d}>"


def _sass_counts() -> dict:
    """Each bf16 (wgmma) flash instantiation's count of the ``MMA_SASS``
    instructions in the built library's SASS (the toolkit's ``cuobjdump
    -sass``), keyed by kernel and template arguments."""
    from torch.utils.cpp_extension import CUDA_HOME
    from torchft_tpu_torch import _build

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", _build.KERNEL_LIB], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = next((n for n in MMA_INSTANCES if n in m.group(1)), None)
            shape = _template_args(m.group(1))
            key = name + _instance_key(*shape) if name and shape else None
            if key:
                counts[key] = dict.fromkeys(MMA_SASS, 0)
        elif key:
            for op in MMA_SASS:
                counts[key][op] += op in line
    return counts


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _capture(fn) -> "torch.cuda.CUDAGraph":
    """``fn``'s launches captured as one CUDA graph (after a warm-up on a
    side stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError as e:
        fail(f"CUDA graph capture failed, no device time to report: {e}")
    return graph


def _graph_ms(fn, iters: int = 20) -> float:
    """Device time of ``fn``'s launches, replayed as one CUDA graph: the
    per-launch host overhead (Python, ctypes) drops out, so this is the
    kernels' own time back to back."""
    return _time_ms(_capture(fn).replay, iters=iters)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    both = torch.isfinite(a) & torch.isfinite(b)
    return float((a[both] - b[both]).abs().max()) if both.any() else 0.0


def _lm_shapes(lm: dict) -> list:
    from torchft_tpu_torch._tree import flatten
    from torchft_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(**lm)
    return [tuple(p.shape) for p in flatten(tt.init_params(cfg, device="meta"))[0]]


def _k1_group_case(qk, label: str, leaves, res0, at: int, cap: int) -> float:
    """K1a and K1b over one plan group (the segmented launches of
    ``quantize_q8_ef_group``) against the group's plain version on the same
    inputs, bit for bit: codes, scales, carry, and K1a's absmax up to which
    NaN. ``at`` puts the carry and the code buffer that many elements off
    their allocations' start. Fails on a difference or on a launch count
    other than one K1a and one K1b per table of up to ``cap`` segments (0:
    the plain versions ran, no launches); returns the largest finite
    difference (0 when it passes)."""
    dev = res0.device
    n = sum(x.numel() for x in leaves)
    outs = []
    for body in ("kernel", "plain"):
        res = torch.empty(n + at, device=dev)[at:]
        res.copy_(res0)
        codes = torch.full((n + at,), 99, dtype=torch.int8, device=dev)[at:]
        scales = torch.full((len(leaves),), 7.0, device=dev)
        before = dict(qk.launch_counts)
        if body == "kernel":
            qk.quantize_q8_ef_group(leaves, res, codes, scales)
            tables = -(-len(leaves) // cap) if cap else 0
            got = (qk.launch_counts["q8_absmax"] - before["q8_absmax"],
                   qk.launch_counts["q8_quantize"] - before["q8_quantize"])
            if got != (tables, tables):
                fail(f"K1 group {label}: launches {got}, want {tables} each")
        else:
            qk.plain_group["quantize_q8_ef"](leaves, res, codes, scales)
        outs.append((codes, scales, res))
    err = 0.0
    for part, u, v in zip(("codes", "scales", "carry"), *outs):
        if not _bits_equal(u, v):
            fail(f"K1b q8_quantize disagrees on the group {label} ({part})")
        err = max(err, _max_abs_err(u, v))
    a_k = qk.q8_absmax_group(leaves, res0)
    a_p = qk.plain_group["q8_absmax"](leaves, res0)
    nan = torch.isnan(a_p)
    if not (torch.equal(torch.isnan(a_k), nan) and _bits_equal(a_k[~nan], a_p[~nan])):
        fail(f"K1a q8_absmax disagrees on the group {label}")
    return err


def _k1_serving_group_case(qk, label: str, leaves, at: int, cap: int) -> float:
    """The serving wire's EF-free group encode (``quantize_q8_group``:
    K1a and K1b over a zero carry the caller owns, the residual into a
    scratch buffer) against ``plain_group["quantize_q8"]`` on the same
    inputs, bit for bit: codes and scales. Fails on a difference, on a
    carry that is no longer all zero after the launches, or on a launch
    count other than one K1a and one K1b per table of up to ``cap``
    segments (0: the plain versions ran, no launches); returns the
    largest finite difference (0 when it passes)."""
    dev = leaves[0].device
    n = sum(x.numel() for x in leaves)
    outs = []
    for body in ("kernel", "plain"):
        codes = torch.full((n + at,), 99, dtype=torch.int8, device=dev)[at:]
        scales = torch.full((len(leaves),), 7.0, device=dev)
        if body == "kernel":
            zeros = torch.zeros(n + at, device=dev)[at:]
            scratch = torch.full((n,), 5.0, device=dev)
            before = dict(qk.launch_counts)
            qk.quantize_q8_group(leaves, codes, scales, zeros, scratch)
            tables = -(-len(leaves) // cap) if cap else 0
            got = (qk.launch_counts["q8_absmax"] - before["q8_absmax"],
                   qk.launch_counts["q8_quantize"] - before["q8_quantize"])
            if got != (tables, tables):
                fail(f"K1 serving group {label}: launches {got}, want "
                     f"{tables} each")
            if bool(zeros.any()):
                fail(f"K1 serving group {label}: the zero carry was written")
        else:
            qk.plain_group["quantize_q8"](leaves, codes, scales)
        outs.append((codes, scales))
    err = 0.0
    for part, u, v in zip(("codes", "scales"), *outs):
        if not _bits_equal(u, v):
            fail(f"K1b q8_quantize (serving, no carry) disagrees on the group "
                 f"{label} ({part})")
        err = max(err, _max_abs_err(u, v))
    return err


def _k3_k2_group_case(qk, label: str, leaves, at: int, cap: int) -> tuple:
    """K3 and K2 over one plan group against their plain group versions on
    the same inputs, bit for bit: K3 casts the leaves into a bf16 wire
    buffer, K2 decodes the codes and scales of a q8ef pack of the same
    leaves. ``at`` puts the bf16 buffer, the codes and K2's output that
    many elements off their allocations' start. Fails on a difference or
    on a launch count other than one K3 and one K2 per table of up to
    ``cap`` segments (0: the plain versions ran, no launches); returns the
    card's (bf16 words, decoded values)."""
    dev = leaves[0].device
    counts = [x.numel() for x in leaves]
    n = sum(counts)
    codes = torch.empty(n + at, dtype=torch.int8, device=dev)[at:]
    scales = torch.empty(len(leaves), device=dev)
    qk.quantize_q8_ef_group(leaves, torch.zeros(n, device=dev), codes, scales)
    outs = []
    for body in ("kernel", "plain"):
        words = torch.full((n + at,), 3.0, dtype=torch.bfloat16, device=dev)[at:]
        vals = torch.full((n + at,), 7.0, device=dev)[at:]
        before = dict(qk.launch_counts)
        if body == "kernel":
            qk.cast_bf16_group(leaves, words)
            qk.dequantize_q8_group(codes, scales, counts, vals)
            tables = -(-len(leaves) // cap) if cap else 0
            got = (qk.launch_counts["cast_bf16"] - before["cast_bf16"],
                   qk.launch_counts["q8_dequantize"] - before["q8_dequantize"])
            if got != (tables, tables):
                fail(f"K3/K2 group {label}: launches {got}, want {tables} each")
        else:
            qk.plain_group["cast_bf16"](leaves, words)
            qk.plain_group["q8_dequantize"](codes, scales, counts, vals)
        outs.append((words, vals))
    (w_k, v_k), (w_p, v_p) = outs
    if not _bits_equal(w_k, w_p):
        fail(f"K3 cast_bf16 disagrees on the group {label}")
    if not _bits_equal(v_k, v_p):
        fail(f"K2 dequantize_q8 disagrees on the group {label}")
    return w_k, v_k


def _alternate_ms(fns: dict, rounds: int, iters: int) -> dict:
    """Device ms per call of each function, each captured once as a CUDA
    graph and replayed ``iters`` times per round, the functions in turns
    round after round: {name: [ms of each round]}."""
    graphs = {name: _capture(fn) for name, fn in fns.items()}
    out = {name: [] for name in fns}
    for _ in range(rounds):
        for name, g in graphs.items():
            out[name].append(_time_ms(g.replay, iters=iters))
    return out


def _host_ms(fn, iters: int = 20) -> float:
    """Host ms per call of ``fn`` (dispatch only: the card is not waited
    for), after a synchronised warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return 1e3 * t


def phase_kernels(device: str = "cuda", timing: bool = True, lm: dict = LM,
                  big_lm: dict = BIG_LM) -> dict:
    from torchft_tpu_torch.collectives import _DeviceWirePacker
    from torchft_tpu_torch.ops import quantize_kernels as qk
    from torchft_tpu_torch.ops._lib import _kernels
    from torchft_tpu_torch.ops.wire_bits import CAST_BF16_WORDS, Q8_DECODE_SPECIALS

    dev = torch.device(device)
    on_card = dev.type == "cuda"  # (the plain versions launch nothing)
    shapes = _lm_shapes(lm)
    if len(shapes) != 39:
        fail(f"expected 39 leaves, got {len(shapes)}")
    gen = torch.Generator(device=dev).manual_seed(7)
    grads = [torch.randn(s, generator=gen, device=dev) * 1e-2 for s in shapes]
    ress = [torch.randn(s, generator=gen, device=dev) * 1e-4 for s in shapes]
    nan_bits = torch.tensor(
        [0x7FC00000, 0x7FFFFFFF, 0x7F800001, -0x00400000, -1, 0x7F800000,
         0x3F818000], dtype=torch.int32, device=dev).view(torch.float32)
    specials = {
        "ragged_1000003": torch.randn(1000003, generator=gen, device=dev),
        "all_zero": torch.zeros(4099, device=dev),
        "nan_leaf": torch.tensor([1.0, float("nan"), -2.0], device=dev),
        "inf_leaf": torch.tensor([1.0, float("inf"), 2.0], device=dev),
        "nan_bit_patterns": nan_bits,
    }
    cases = [(f"leaf{i}{list(s)}", x, r) for i, (s, x, r) in
             enumerate(zip(shapes, grads, ress))]
    cases += [(k, x, torch.zeros_like(x)) for k, x in specials.items()]

    err = {"q8_absmax": 0.0, "q8_quantize": 0.0, "q8_dequantize": 0.0,
           "cast_bf16": 0.0}
    # per leaf: K1a and K1b through their one-segment tables
    for name, x, r in cases:
        a_k, a_p = qk.q8_absmax(x, r), qk.plain["q8_absmax"](x, r)
        if torch.isnan(a_p):  # which NaN is not part of the contract
            ok = bool(torch.isnan(a_k))
        else:
            ok = _bits_equal(a_k, a_p)
            err["q8_absmax"] = max(err["q8_absmax"], _max_abs_err(a_k, a_p))
        if not ok:
            fail(f"K1a q8_absmax disagrees on {name}")
        got = qk.q8_quantize(x, r, a_k)
        want = qk.plain["q8_quantize"](x, r, a_p)
        for part, u, v in zip(("q", "scale", "res"), got, want):
            if not _bits_equal(u, v):
                fail(f"K1b q8_quantize disagrees on {name} ({part})")
            err["q8_quantize"] = max(err["q8_quantize"], _max_abs_err(u, v))
        d_k = qk.dequantize_q8(got[0], got[1])
        d_p = qk.plain["q8_dequantize"](got[0], got[1])
        if not _bits_equal(d_k, d_p):
            fail(f"K2 dequantize_q8 disagrees on {name}")
        err["q8_dequantize"] = max(err["q8_dequantize"], _max_abs_err(d_k, d_p))
        if not _bits_equal(qk.cast_bf16(x), qk.plain["cast_bf16"](x)):
            fail(f"K3 cast_bf16 disagrees on {name}")
    canon = qk.cast_bf16(nan_bits).view(torch.int16).tolist()
    if [v & 0xFFFF for v in canon] != [0x7FC0, 0x7FC0, 0x7FC0, 0xFFC0, 0xFFC0,
                                       0x7F80, 0x3F82]:
        fail(f"K3 NaN bit patterns wrong: {[hex(v & 0xFFFF) for v in canon]}")
    q, s, r = qk.quantize_q8_ef(specials["inf_leaf"], torch.zeros(3, device=dev))
    if q.tolist() != [0, 0, 0] or s.view(torch.int32).item() != 0x7FC00000 or \
            (r.view(torch.int32) != 0x7FC00000).any():
        fail("K1 non-finite leaf does not poison with 0x7FC00000")
    if (qk.dequantize_q8(q, s).view(torch.int32) != 0x7FC00000).any():
        fail("K2 NaN scale does not poison the leaf with 0x7FC00000")
    if qk.dequantize_q8(torch.zeros(0, dtype=torch.int8, device=dev), s).shape != (0,):
        fail("K2 empty leaf")
    # the bf16 wire's one f32 group, flat (one segment)
    group = torch.cat([x.reshape(-1) for x in grads])
    b_k, b_p = qk.cast_bf16(group), qk.plain["cast_bf16"](group)
    if not _bits_equal(b_k, b_p):
        fail("K3 cast_bf16 disagrees on the flat 23.3M-element group")
    err["cast_bf16"] = max(err["cast_bf16"], _max_abs_err(b_k, b_p))
    log(f"  {len(cases)} cases + the flat bf16 group: K1a, K1b, K2, K3 "
        "bit-identical to their plain versions (each through one-segment "
        "tables; K2 on K1b's codes and scales, NaN scale and empty leaf "
        "included)")

    # K1a/K1b over whole plan groups (one launch each per table)
    res_flat = torch.cat([r.reshape(-1) for r in ress])
    flash_shapes = _lm_shapes(big_lm)
    if len(flash_shapes) != 51:
        fail(f"expected 51 flash leaves, got {len(flash_shapes)}")
    fgrads = [torch.randn(s, generator=gen, device=dev) * 1e-2 for s in flash_shapes]
    fres = torch.randn(sum(x.numel() for x in fgrads), generator=gen,
                       device=dev) * 1e-4
    sp = list(specials.values())
    sp_group = sp[:3] + [torch.zeros(0, device=dev)] + sp[3:] + [grads[0]]
    unaligned = torch.randn(70001 + 16, generator=gen, device=dev)
    emb = grads[0].reshape(-1)
    cap = _kernels.lib().tft_seg_capacity() if on_card else 64
    sizes = torch.randint(0, 3000, (2 * cap + 77,), generator=torch.Generator()
                          .manual_seed(8)).tolist()
    small = [torch.randn(n, generator=gen, device=dev) for n in sizes]
    group_cases = [
        ("dense 39 leaves", grads, res_flat, 0),
        ("flash 51 leaves", fgrads, fres, 0),
        ("specials (ragged 1000003, all-zero, NaN, empty, Inf, NaN bit "
         "patterns)", sp_group, None, 0),
        ("views at storage offset 1", [unaligned[1:4100], unaligned[4101:70001]],
         None, 1),
        ("views at storage offset 3", [unaligned[3:65540], unaligned[65541:65542]],
         None, 3),
        ("code offsets off the 4-byte grid", [emb[:3], emb[8:13], emb[16:1019],
                                              emb[2048:72049]], None, 0),
        (f"{len(small)} leaves (past the {cap}-segment table)", small, None, 0),
    ]
    for label, leaves, res0, at in group_cases:
        if res0 is None:
            res0 = torch.randn(sum(x.numel() for x in leaves), generator=gen,
                               device=dev) * 1e-3
        e = _k1_group_case(qk, label, leaves, res0, at, cap if on_card else 0)
        err["q8_quantize"] = max(err["q8_quantize"], e)
    _k1_group_case(qk, "dense, again", grads, res_flat, 0, cap if on_card else 0)
    log(f"  {len(group_cases)} plan groups ({', '.join(c[0] for c in group_cases)}):"
        " K1a and K1b bit-identical to the plain group version, one launch each "
        "per table; the dense group bit-identical run to run")
    # the serving wire's encode (no carry) over the same groups: the flash
    # group's 51 leaves are the serving phase's shapes
    for label, leaves, _, at in group_cases:
        e = _k1_serving_group_case(qk, label, leaves, at, cap if on_card else 0)
        err["q8_quantize"] = max(err["q8_quantize"], e)
    log(f"  the same {len(group_cases)} groups through quantize_q8_group (the "
        "serving encode, zero carry): codes and scales bit-identical to "
        "plain_group['quantize_q8'], the carry left zero, one launch each "
        "per table")

    # K3 and K2 over whole plan groups (one launch each per table): the
    # same groups, a mixed f32/bf16 group (a bf16 NaN payload 0x7FC1 among
    # its leaves), and the cast's bit patterns
    k_cap = cap if on_card else 0
    payload_nan = torch.tensor([0x7FC1, -0x7F], dtype=torch.int16,
                                device=dev).view(torch.bfloat16)
    patterns = torch.tensor(list(CAST_BF16_WORDS), dtype=torch.int64,
                            device=dev).to(torch.int32).view(torch.float32)
    wire_cases = [(label, leaves, at) for label, leaves, _, at in group_cases]
    wire_cases += [
        ("mixed f32/bf16", [grads[0], grads[1].to(torch.bfloat16), payload_nan,
                            grads[2], fgrads[3].to(torch.bfloat16)], 0),
        ("cast bit patterns", [grads[4], patterns, torch.zeros(0, device=dev)], 0),
    ]
    wire_out = {}
    for label, leaves, at in wire_cases:
        wire_out[label] = _k3_k2_group_case(qk, label, leaves, at, k_cap)
    tail = wire_out["cast bit patterns"][0][-len(CAST_BF16_WORDS):]
    words = [v & 0xFFFF for v in tail.view(torch.int16).tolist()]
    if words != list(CAST_BF16_WORDS.values()):
        fail(f"K3 bit patterns wrong: {[hex(v) for v in words]}")
    mixed = wire_out["mixed f32/bf16"][0]
    off = grads[0].numel() + grads[1].numel()
    if [v & 0xFFFF for v in mixed[off:off + 2].view(torch.int16).tolist()] != \
            [0x7FC0, 0xFFC0]:
        fail("K3 does not turn a bf16 NaN payload into sign | 0x7FC0")
    again = _k3_k2_group_case(qk, "dense, again", grads, 0, k_cap)
    first = wire_out[group_cases[0][0]]
    if not (_bits_equal(again[0], first[0]) and _bits_equal(again[1], first[1])):
        fail("K3/K2 over the dense group differ run to run")
    # K2's special scales
    sc_bits, sc_codes, want_bits = Q8_DECODE_SPECIALS
    k2_codes = torch.tensor([c for cs in sc_codes for c in cs], dtype=torch.int8,
                            device=dev)
    k2_scales = torch.tensor(sc_bits, dtype=torch.int64,
                             device=dev).to(torch.int32).view(torch.float32)
    counts = [len(cs) for cs in sc_codes]
    vals = []
    for fn in (qk.dequantize_q8_group, qk.plain_group["q8_dequantize"]):
        vals.append(torch.empty(sum(counts), device=dev))
        fn(k2_codes, k2_scales, counts, vals[-1])
    got = [v & 0xFFFFFFFF for v in vals[0].view(torch.int32).tolist()]
    if got != want_bits or not _bits_equal(vals[0], vals[1]):
        fail(f"K2 special scales wrong: {[hex(v) for v in got]}")
    log(f"  {len(wire_cases)} plan groups ({', '.join(c[0] for c in wire_cases)}):"
        " K3 and K2 (on a q8ef pack of the same leaves) bit-identical to the "
        "plain group versions, one launch each per table; the dense group "
        "bit-identical run to run; K3's bit patterns, the bf16 NaN payload and "
        "K2's NaN, Inf and subnormal scales as specified")

    if not timing:
        return {}
    n = sum(x.numel() for x in grads)
    nf = sum(x.numel() for x in fgrads)
    absmaxes = [qk.q8_absmax(x, r) for x, r in zip(grads, ress)]
    neg_ress = [-r for r in ress]
    # the group passes over a copy of each carry (K1b advances it in place);
    # K2 decodes a q8ef pack of each group, K3 casts it into its wire buffer
    wire, dec = {}, {}
    for key, xs, r0 in (("dense", grads, res_flat), ("flash", fgrads, fres)):
        carry = r0.clone()
        am = qk.q8_absmax_group(xs, carry)
        c8 = torch.empty(carry.numel(), dtype=torch.int8, device=dev)
        sc = torch.empty(len(xs), device=dev)
        wire[key] = (
            lambda xs=xs, carry=carry: qk.q8_absmax_group(xs, carry),
            lambda xs=xs, carry=carry, am=am, c8=c8, sc=sc:
                qk.q8_quantize_group(xs, carry, am, c8, sc),
        )
        qk.quantize_q8_ef_group(xs, r0.clone(), c8, sc)
        counts = [x.numel() for x in xs]
        out = torch.empty(carry.numel(), device=dev)
        dec[key] = (
            lambda c8=c8, sc=sc, counts=counts, out=out:
                qk.dequantize_q8_group(c8, sc, counts, out),
            [(c.view(x.shape), s) for c, s, x in
             zip(torch.split(c8, counts), sc, xs)],  # each leaf's codes, scale
        )
    words = torch.empty(n, dtype=torch.bfloat16, device=dev)
    k3_group = lambda: qk.cast_bf16_group(grads, words)
    k3_flat = lambda: qk.cast_bf16_group([group], words)
    # the parent's bf16 pack: the f32 concatenation, then one flat cast
    cat_then_k3 = lambda: qk.cast_bf16(torch.cat([x.reshape(-1) for x in grads]))
    k2_leaves = lambda: [qk.dequantize_q8(c, s) for c, s in dec["dense"][1]]
    log(f"  eager, launch overhead included: K1a {_time_ms(wire['dense'][0]):.4f}"
        f" ms, K1b {_time_ms(wire['dense'][1]):.4f} ms, K2 "
        f"{_time_ms(dec['dense'][0]):.4f} ms, K3 {_time_ms(k3_group):.4f} ms "
        f"over the dense group")
    for key, xs in (("dense", grads), ("flash", fgrads)):
        for wire_name in ("q8ef", "bf16"):
            packer = _DeviceWirePacker(xs, wire_name)
            torch.cuda.synchronize()
            pack = lambda packer=packer, xs=xs: packer._pack_on_device(xs)
            log(f"  _DeviceWirePacker._pack_on_device, {wire_name} wire, {key} "
                f"group ({len(xs)} leaves): eager {_time_ms(pack):.4f} ms per "
                f"call (card time with host dispatch in between), host "
                f"dispatch alone {_host_ms(pack):.4f} ms")
            del packer
    # ms, plain ms, library ms: device time of one step's launches (CUDA
    # graph replay), except the plain quantize, which synchronises per
    # leaf and is timed eagerly.
    times = {
        "q8_absmax": (
            _graph_ms(wire["dense"][0]),
            _graph_ms(lambda: [qk.plain["q8_absmax"](x, r)
                               for x, r in zip(grads, ress)]),
            # one PyTorch call per leaf computing max|x + res|: max|x - (-res)|
            _graph_ms(lambda: [torch.dist(x, nr, p=float("inf"))
                               for x, nr in zip(grads, neg_ress)]),
            8,   # bytes per element: reads x and res
        ),
        "q8_quantize": (
            _graph_ms(wire["dense"][1]),
            _time_ms(lambda: [qk.plain["q8_quantize"](x, r, a) for x, r, a in
                              zip(grads, ress, absmaxes)], iters=5),
            None,  # no single PyTorch call quantizes with error feedback
            13,    # reads x and res, writes int8 codes and the residual
        ),
        "q8_dequantize": (
            _graph_ms(dec["dense"][0]),
            _graph_ms(lambda: [qk.plain["q8_dequantize"](c, s)
                               for c, s in dec["dense"][1]]),
            # one PyTorch call per leaf: int8 codes times the f32 0-d scale
            _graph_ms(lambda: [torch.mul(c, s) for c, s in dec["dense"][1]]),
            5,   # reads int8 codes, writes f32
        ),
        "cast_bf16": (
            _graph_ms(k3_group),
            _graph_ms(lambda: qk.plain_group["cast_bf16"](grads, words)),
            # one PyTorch call on the flat group (the same values)
            _graph_ms(lambda: group.to(torch.bfloat16)),
            6,   # reads f32, writes bf16
        ),
    }
    over = dict.fromkeys(times, "the dense group (39 leaves)")
    flash_ms = {"q8_absmax": _graph_ms(wire["flash"][0]),
                "q8_quantize": _graph_ms(wire["flash"][1]),
                "q8_dequantize": _graph_ms(dec["flash"][0])}
    rows = {}
    for name, (ms, plain_ms, lib_ms, per_elt) in times.items():
        rows[name] = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCES[name],
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": per_elt * n / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": lib_ms,
        }
        log(f"  {name}: {ms:.4f} ms over {over[name]} vs plain {plain_ms:.4f}"
            f" ms, library {lib_ms if lib_ms is None else round(lib_ms, 4)} "
            f"ms, bound {rows[name]['bound_ms']:.4f} ms "
            f"({rows[name]['bound_ms'] / ms:.1%} of it)")
        if name in flash_ms:
            rows[name]["ms_flash_group"] = flash_ms[name]
            rows[name]["bound_ms_flash_group"] = per_elt * nf / HBM_BYTES_PER_S * 1e3
            log(f"  {name}: {flash_ms[name]:.4f} ms over the flash group (51 "
                f"leaves, {nf} elements), bound "
                f"{rows[name]['bound_ms_flash_group']:.4f} ms "
                f"({rows[name]['bound_ms_flash_group'] / flash_ms[name]:.1%})")
    rows["q8_dequantize"]["ms_per_leaf_launches"] = _graph_ms(k2_leaves)
    log(f"  q8_dequantize: {rows['q8_dequantize']['ms_per_leaf_launches']:.4f} ms"
        " as 39 one-segment launches (one per leaf) over the dense group")
    # In turns: K3 over the dense group in place, over the flat group (one
    # segment), the parent's pack sequence (f32 torch.cat, then the flat
    # cast) and x.to(torch.bfloat16) on the flat group
    k3_vs = _alternate_ms({"cast_bf16_group": k3_group, "cast_bf16_flat": k3_flat,
                           "to_bf16": lambda: group.to(torch.bfloat16),
                           "cat_then_cast_bf16": cat_then_k3},
                          rounds=K3_ROUNDS, iters=K3_REPLAYS)
    log(f"  K3 in turns, {K3_ROUNDS} rounds of {K3_REPLAYS} graph replays "
        f"each, ms: {json.dumps(k3_vs)}")
    for name in k3_vs:
        vals = sorted(k3_vs[name])
        log(f"    {name}: median {vals[len(vals) // 2]:.5f} ms, spread "
            f"{vals[0]:.5f}-{vals[-1]:.5f} ms")
    medians = {k: sorted(v)[len(v) // 2] for k, v in k3_vs.items()}
    rows["cast_bf16"]["ms_flat"] = medians["cast_bf16_flat"]
    rows["cast_bf16"]["ms_cat_then_cast"] = medians["cat_then_cast_bf16"]
    return rows


def _flash_pairs(S: int, causal: bool, window) -> int:
    """Live (query, key) pairs of one (batch, head) slice."""
    if window is not None:
        w = min(window, S)  # row q sees min(q + 1, w) keys
        return w * (w + 1) // 2 + (S - w) * w
    return S * (S + 1) // 2 if causal else S * S


def _flash_bound(kind: str, shape, dtype, causal: bool, window) -> tuple:
    """(bound ms, what bounds it) of one K4 ("fwd") or K5 ("bwd") call:
    the larger of the minimal operations (2 products of 2 flops per live
    pair and head dim forward, 5 backward) over the dtype's peak, and the
    bytes (forward reads q, k, v and writes out and the f32 lse; backward
    reads q, k, v, out, do and lse and writes dq, dk, dv) over HBM's."""
    B, S, H, D = shape
    flops = (4 if kind == "fwd" else 10) * B * H * _flash_pairs(S, causal, window) * D
    n, elt, rows = B * S * H * D, torch.finfo(dtype).bits // 8, B * H * S
    nbytes = (4 * n * elt + 4 * rows) if kind == "fwd" else (8 * n * elt + 4 * rows)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _delta_off(got: torch.Tensor, want: torch.Tensor, out: torch.Tensor,
               do: torch.Tensor) -> int:
    """Rows of a kernel's delta (B, H, S) f32 off the torch delta by more
    than f32 rounding: rtol 1e-6, plus the bound on two summation orders
    of D products, 2 D 2**-24 of the row's sum of |do * out|."""
    mag = (do.float() * out.float()).abs().sum(-1).transpose(1, 2)
    tol = 1e-6 * want.abs() + 2 * do.shape[-1] * 2.0 ** -24 * mag
    return int(((got - want).abs() > tol).sum())


def _flash_case(tfa, label: str, shape, dtype, causal=True, window=None,
                block_k=None, chunk: int = 2, device: str = "cuda") -> dict:
    """K4 and K5 on the card against their plain versions on the same
    inputs (the plain backward gets the kernel's lse and out and the torch
    delta, which the dq kernel's own must match), in
    batch chunks of ``chunk`` so the plain (S, S) scores stay small.
    Fails past the tolerance; returns the inputs and errors."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(sum(shape) + (window or 0))
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(4))
    cfg = tfa.FlashConfig(causal, window, *tfa.resolve_blocks(
        shape[1], dev, None, block_k))
    out, lse = tfa.flash_fwd(q, k, v, cfg)
    delta = tfa.flash_delta_plain(out, do)
    if dev.type == "cuda":  # the kernels' own delta, folded into dq
        *grads, kdelta = tfa.flash_bwd_kernels(q, k, v, out, lse, do, cfg)
        bad_rows = _delta_off(kdelta, delta, out, do)
        if bad_rows:
            fail(f"flash {label}: the dq kernel's delta is off the torch "
                 f"delta in {bad_rows} rows")
    else:
        grads = tfa.flash_bwd(q, k, v, out, lse, do, cfg)
    names = ("out", "lse", "dq", "dk", "dv")
    err = dict.fromkeys(names, 0.0)
    tol = dict.fromkeys(names, 0.0)
    for b0 in range(0, shape[0], chunk):
        sl = slice(b0, b0 + chunk)
        want = (*tfa.flash_fwd_plain(q[sl], k[sl], v[sl], cfg),
                *tfa.flash_bwd_plain(q[sl], k[sl], v[sl], do[sl], lse[sl],
                                     delta[sl], cfg))
        for name, got, ref in zip(names, (out, lse, *grads), want):
            got = got[sl]
            if got.dtype != ref.dtype or got.shape != ref.shape:
                fail(f"flash {label}: {name} is {got.dtype} {tuple(got.shape)}")
            if not torch.isfinite(got).all():
                fail(f"flash {label}: non-finite {name}")
            err[name] = max(err[name], float((got.float() - ref.float()).abs().max()))
            tol[name] = max(tol[name], tfa.plain_tolerance(name, ref))
    bad = [n for n in names if err[n] > tol[n]]
    log(f"  flash {label} {tuple(shape)} {str(dtype)[6:]} causal={causal} "
        f"window={window} blocks={cfg.block_q}x{cfg.block_k} fast={cfg.fast}: "
        + ", ".join(f"{n} err {err[n]:.3g} (tol {tol[n]:.3g})" for n in names))
    if bad:
        fail(f"flash {label}: {bad} past tolerance")
    return {"q": q, "k": k, "v": v, "do": do, "out": out, "lse": lse,
            "delta": delta, "cfg": cfg, "grads": grads, "err": err}


def _sdpa_forward(q, k, v, causal: bool):
    """One PyTorch call computing K4's output on the same (pre-scaled)
    inputs. Timed only; the port never calls it."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, scale=1.0)


def _sdpa_backward(q, k, v, do, causal: bool):
    """One PyTorch call computing K5's function on the same (pre-scaled)
    inputs: aten's flash-attention backward, given its own forward's out
    and lse. Timed only; the port never calls it."""
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.0, causal, False, scale=1.0)
    out, lse, cq, ck, mq, mk, seed, offset = fwd[:8]
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        dot, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, causal, seed, offset,
        scale=1.0)


def phase_flash_kernels() -> dict:
    import importlib

    tfa = importlib.import_module("torchft_tpu_torch.ops.flash_attention")
    from torchft_tpu_torch.ops._lib import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain f32 products
    B, S, H, D = FLASH_SHAPE
    path = _flash_case(tfa, "path", FLASH_SHAPE, torch.bfloat16)
    _flash_case(tfa, "S2048", (4, S + 1, H, D), torch.bfloat16)
    _flash_case(tfa, "non-causal", (2, S, H, D), torch.bfloat16, causal=False)
    for w in (1, 16, 200, 1000):
        _flash_case(tfa, f"window{w}", (2, S, H, D), torch.bfloat16, window=w)
    _flash_case(tfa, "block_k32", (2, S, H, D), torch.bfloat16, block_k=32)
    _flash_case(tfa, "head_dim128", (2, S, H // 2, 2 * D), torch.bfloat16)
    _flash_case(tfa, "f32", (2, S, H, D), torch.float32)
    q, k, v, do, out, lse, delta, cfg = (path[n] for n in (
        "q", "k", "v", "do", "out", "lse", "delta", "cfg"))
    if not all(_bits_equal(a, b) for a, b in zip(
            (out, lse), tfa.flash_fwd(q, k, v, cfg))):
        fail("K4 flash_fwd is not bit-identical run to run")
    again = tfa.flash_bwd(q, k, v, out, lse, do, cfg)
    if not all(_bits_equal(a, b) for a, b in zip(path["grads"], again)):
        fail("K5 flash_bwd is not bit-identical run to run")
    log("  K4 and K5 run twice on the path's inputs: bit-identical")
    sass = _sass_counts()
    log(f"  K4/K5 route {MMA_ROUTE}: {'/'.join(MMA_SASS)} instructions in "
        f"each bf16 kernel's SASS {json.dumps(sass)}")
    want = [n + i for n, insts in MMA_INSTANCES.items() for i in insts]
    if sorted(sass) != sorted(want) or not all(
            all(c.values()) for c in sass.values()):
        fail(f"the bf16 flash kernels' SASS lacks {MMA_SASS}: {sass}")

    # device times at the path's shape (graph replay; the plain versions,
    # one to a few seconds a call, eagerly)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    kdelta = torch.empty_like(delta)
    # the stream is read at each launch: the capture's, not the default;
    # dq (which writes delta) first, as flash_bwd launches them
    split = {
        "dq": _graph_ms(lambda: _kernels.launch(
            "flash_bwd", "tft_flash_bwd_dq", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), out.data_ptr(), lse.data_ptr(),
            kdelta.data_ptr(), dq.data_ptr(),
            *tfa._kernel_args(cfg, (q, k, v, do, out)))),
        "dkdv": _graph_ms(lambda: _kernels.launch(
            "flash_bwd", "tft_flash_bwd_dkdv", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), kdelta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            *tfa._kernel_args(cfg, (q, k, v, do)))),
        # the torch pass the parent ran before the kernels (timed only)
        "torch_delta": _graph_ms(lambda: (do.float() * out.float()).sum(-1)
                                 .transpose(1, 2).contiguous()),
    }
    times = {
        "flash_fwd": (
            _graph_ms(lambda: tfa.flash_fwd(q, k, v, cfg)),
            _time_ms(lambda: tfa.flash_fwd_plain(q, k, v, cfg), iters=3, warmup=1),
            _graph_ms(_sdpa_forward(q, k, v, True)),
            _flash_bound("fwd", FLASH_SHAPE, torch.bfloat16, True, None),
            max(path["err"]["out"], path["err"]["lse"]),
        ),
        "flash_bwd": (
            _graph_ms(lambda: tfa.flash_bwd(q, k, v, out, lse, do, cfg)),
            _time_ms(lambda: tfa.flash_bwd_plain(q, k, v, do, lse, delta, cfg),
                     iters=2, warmup=1),
            _graph_ms(_sdpa_backward(q, k, v, do, True)),
            _flash_bound("bwd", FLASH_SHAPE, torch.bfloat16, True, None),
            max(path["err"][n] for n in ("dq", "dk", "dv")),
        ),
    }
    rows = {}
    for name, (ms, plain_ms, lib_ms, (bound_ms, bound_by), err) in times.items():
        rows[name] = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCES[name],
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
        }
        log(f"  {name} at {FLASH_SHAPE} bf16 causal: {ms:.3f} ms vs plain "
            f"{plain_ms:.3f} ms, scaled_dot_product_attention {lib_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}; the kernel at "
            f"{bound_ms / ms:.1%} of it)")
    log(f"  flash_bwd split: dq kernel (with delta) {split['dq']:.3f} ms, "
        f"dk/dv kernel {split['dkdv']:.3f} ms (the torch delta pass they "
        f"replace: {split['torch_delta']:.3f} ms)")
    # flops over the path's live (query, key) pairs: 2 per pair and head dim
    # for each product (K4 2, K5 5 minimal; the split executes dk/dv 4, dq 3)
    pair_flops = 2 * B * H * _flash_pairs(S, True, None) * D
    tflops = lambda products, ms: products * pair_flops / ms / 1e9
    log(f"  achieved at {FLASH_SHAPE} (bf16 bound {PEAK_FLOPS[torch.bfloat16] / 1e12:.0f}"
        f" TFLOP/s): K4 ({MMA_ROUTE}) {tflops(2, rows['flash_fwd']['ms']):.1f}"
        f" TFLOP/s; K5 ({MMA_ROUTE}) "
        f"{tflops(5, rows['flash_bwd']['ms']):.1f} TFLOP/s of its minimal "
        f"work, the dq kernel {tflops(3, split['dq']):.1f} and the dk/dv "
        f"kernel {tflops(4, split['dkdv']):.1f} of the products each executes "
        f"(3 and 4); scaled_dot_product_attention forward "
        f"{tflops(2, rows['flash_fwd']['library_ms']):.1f}, backward "
        f"{tflops(5, rows['flash_bwd']['library_ms']):.1f}")
    return rows


class _WarmPool:
    """Spare processes of this script that have already paid a process's
    start on the card's host (``import torch``, 8–11 s there, the CUDA
    context, under 1 s, and the first flash call, 10–14 s: see
    ``--start-probe``) and wait on their stdin for the arguments of the
    worker they become. Each one taken is replaced at once, so the next
    generation of workers starts while this one runs."""

    def __init__(self, size: int) -> None:
        self._lock = threading.Lock()
        # every spare starts from this environment: a phase that sets a
        # variable in this process for a while (the bench phase's model
        # knobs) must not leak it into the replacements started meanwhile
        self._env = dict(os.environ)
        self._idle = [self._start() for _ in range(size)]
        self.warm = self.cold = 0

    def _start(self) -> subprocess.Popen:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--pooled"],
            cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, env=self._env)

    def popen(self, argv: list, log_path: "str | None",
              script: str = __file__,
              err_path: "str | None" = None,
              env: "dict | None" = None) -> subprocess.Popen:
        """A process running ``script *argv`` (this script's by default)
        with its stdout in ``log_path`` and its stderr there too, or in
        ``err_path``, and ``env`` added to its environment: a warm spare
        if one is alive, else a cold start. ``log_path=None`` keeps its
        stdin and stdout as pipes to the caller (``proc.stdin`` /
        ``proc.stdout``)."""
        with self._lock:
            self._idle = [p for p in self._idle if p.poll() is None]
            proc = self._idle.pop(0) if self._idle else None
            self._idle.append(self._start())
        script = os.path.abspath(script)
        if proc is None:
            self.cold += 1
            return _cold_popen(script, argv, log_path, err_path, env)
        self.warm += 1
        proc.stdin.write(json.dumps({"script": script, "argv": argv,
                                     "log": log_path, "err": err_path,
                                     "env": env or {}}) + "\n")
        proc.stdin.flush()
        if log_path is not None:
            proc.stdin.close()
            proc.stdout.close()
        proc.args = [sys.executable, script, *argv]
        return proc

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for p in idle:
            p.kill()
            p.wait()


# the card run's pool (None: every worker starts cold, as on the CPU)
POOL: "_WarmPool | None" = None
POOL_SIZE = 4  # the largest generation: four hier dense groups, four ranks


# the pool's warm-up model: one flash block, small enough to cost nothing
POOL_WARM_LM = dict(vocab_size=256, d_model=128, n_heads=2, n_layers=1,
                    d_ff=256, max_seq_len=128, use_flash=True)


def _pooled() -> int:
    """A spare's life: warm up, wait for its arguments, become that
    worker (stdout and stderr into the log the parent named). On the
    card the warm-up runs one forward/backward of a one-block flash LM:
    a process's first flash call costs 10–14 s there, whatever its shape
    (the imports of torch's custom-op machinery and the first launches),
    and the flash LM's first after it under 0.4 s. Launch counts go back
    to 0 after it, as in a fresh process."""
    import torchft_tpu_torch  # noqa: F401

    if torch.cuda.is_available():
        from torchft_tpu_torch.models import transformer as tt
        from torchft_tpu_torch.ops import reset_launch_counts

        cfg = tt.TransformerConfig(**POOL_WARM_LM)
        params = tt.TransformerLM(cfg, seed=0, device="cuda").params()
        tokens = torch.zeros((2, 65), dtype=torch.long, device="cuda")
        tt.make_grad_fn(cfg)(params, tokens)
        torch.cuda.synchronize()
        del params, tokens
        torch.cuda.empty_cache()
        reset_launch_counts()
    line = sys.stdin.readline()
    if not line:
        return 0  # closed unused
    job = json.loads(line)
    global T_WORK
    T_WORK = time.perf_counter()
    os.environ.update(job["env"])
    for target, path in ((1, job["log"]), (2, job["err"] or job["log"])):
        if path is None:
            continue  # stdout stays the pipe to the caller
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        os.dup2(fd, target)
        os.close(fd)
    sys.argv = [job["script"], *job["argv"]]
    if job["script"] == os.path.abspath(__file__):
        return main()
    import runpy

    runpy.run_path(job["script"], run_name="__main__")  # exits by SystemExit
    return 0


def _cold_popen(script: str, argv: list, log_path: "str | None",
                err_path: "str | None" = None,
                env: "dict | None" = None) -> subprocess.Popen:
    env = {**os.environ, **env} if env else None
    if log_path is None:  # pipes to the caller, stderr to its log
        return subprocess.Popen(
            [sys.executable, script, *argv], cwd=REPO, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=open(err_path, "w"), text=True,
            env=env)
    out = open(log_path, "w")
    err = open(err_path, "w") if err_path else subprocess.STDOUT
    return subprocess.Popen([sys.executable, script, *argv], cwd=REPO,
                            stdout=out, stderr=err, env=env)


def _popen_worker(argv: list, log_path: "str | None",
                  script: str = __file__,
                  err_path: "str | None" = None,
                  cold: bool = False,
                  env: "dict | None" = None) -> subprocess.Popen:
    """This script's worker (or ``script``) through the pool, if any,
    with ``env`` added to its environment; ``cold``: a fresh interpreter
    whatever the pool holds (a restart after a SIGKILL, whose
    kill-to-first-commit includes the start)."""
    if POOL is not None and not cold:
        return POOL.popen(argv, log_path, script, err_path, env)
    return _cold_popen(os.path.abspath(script), argv, log_path, err_path,
                       env)


def _spawn(cfg: dict, logdir: str, cold: bool = False) -> subprocess.Popen:
    return _popen_worker(["--worker", json.dumps(cfg)],
                         os.path.join(logdir, f"worker_{cfg['group']}.log"),
                         cold=cold)


def _join(procs, deadline: float, workdir: str) -> None:
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        fail("a worker did not finish in time")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p in procs:
        if p.returncode != 0:
            g = json.loads(p.args[-1])["group"]
            with open(os.path.join(workdir, f"worker_{g}.log")) as f:
                tail = f.read()[-3000:]
            fail(f"worker {g} exited {p.returncode}:\n{tail}")


def phase_train_and_heal(workdir: str, device: str = "cuda", lm: dict = LM,
                         batch: int = BATCH, seq: int = SEQ) -> dict:
    import torchft_tpu_torch as tft

    lighthouse = tft.Lighthouse(min_replicas=2, join_timeout_ms=10000,
                                quorum_tick_ms=50, heartbeat_timeout_ms=10000)
    base = {"lighthouse": lighthouse.address(), "workdir": workdir,
            "data_offset": 0, "device": device,
            "lm": lm, "batch": batch, "seq": seq}
    t0 = time.perf_counter()
    procs = []
    try:
        procs = [_spawn({**base, "group": g, "role": "founder"}, workdir)
                 for g in (0, 1)]
        deadline = time.monotonic() + 600
        for g in (0, 1):
            path = os.path.join(workdir, f"ready_{g}")
            while not os.path.exists(path):
                if any(p.poll() not in (None, 0) for p in procs):
                    _join(procs, deadline, workdir)
                if time.monotonic() > deadline:
                    fail("founders never finished the train phase")
                time.sleep(0.1)
        t_train = time.perf_counter() - t0
        log(f"  train phase done in {t_train:.1f} s; starting the late joiner")
        procs.append(_spawn({**base, "group": 2, "role": "late"}, workdir))
        _join(procs, deadline, workdir)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        lighthouse.shutdown()
    results = []
    for g in (0, 1, 2):
        with open(os.path.join(workdir, f"result_{g}.json")) as f:
            results.append(json.load(f))
    return {"results": results, "train_s": t_train,
            "total_s": time.perf_counter() - t0}


def check_training(res: dict, expect_leaves: int = 39,
                   on_card: bool = True) -> dict:
    results = res["results"]
    launches = {}
    step_s, compute_s = [], []
    for r in results:
        g, n_leaves = r["group"], r["n_leaves"]
        if n_leaves != expect_leaves:
            fail(f"group {g}: {n_leaves} leaves")
        for phase, ph in r["phases"].items():
            if not all(ph["commits"]) or not ph["commits"]:
                fail(f"group {g} {phase}: uncommitted step {ph['commits']}")
            if not all(map(_finite, ph["losses"])):
                fail(f"group {g} {phase}: non-finite loss {ph['losses']}")
            want = dict.fromkeys(ph["launches"], 0)
            if on_card:  # (on the CPU the plain versions ran: no launches)
                if phase == "bf16":
                    want["cast_bf16"] = ph["dispatches"]
                else:
                    # one K1a and one K1b per plan group per step: a q8
                    # plan is one f32 group, and its 39 leaves fit one table
                    want["q8_absmax"] = want["q8_quantize"] = ph["dispatches"]
            if ph["launches"] != want:
                fail(f"group {g} {phase}: launches {ph['launches']} != {want}")
            for k, n in ph["launches"].items():
                launches[k] = launches.get(k, 0) + n
            log(f"  group {g} {phase}: {ph['dispatches']} steps committed, "
                f"step {ph['step']}, losses {[round(l, 4) for l in ph['losses']]}"
                f", launches {ph['launches']}")
        if "q8" in r["phases"]:
            # a phase's first step settles nothing: it is not a steady step
            step_s += r["phases"]["q8"]["step_s"][1:]
            compute_s.append(r["compute_s"])
    f0, f1, late = results
    if on_card and not f0.get("trace", {}).get("ring_windows_ms"):
        fail(f"the trace shows no ring window: {f0.get('trace')}")
    for phase in ("warm", "q8", "traced", "bf16", "heal"):
        if f0["phases"][phase]["digest"] != f1["phases"][phase]["digest"]:
            fail(f"founders' parameters differ after the {phase} phase")
    if late["phases"]["heal"]["digest"] != f0["phases"]["heal"]["digest"]:
        fail("the healed group's parameters differ from the donor's")
    if late.get("heals", 0) < 1 or not late.get("fetch"):
        fail(f"the late group never healed: {late.get('heals')} {late.get('fetch')}")
    if late["fetch"]["path"] != "stream":
        fail(f"the late group healed off the stream path: {late['fetch']}")
    log(f"  late group healed ({late['fetch']}) and ended bit-identical at "
        f"step {late['phases']['heal']['step']}")
    step_s.sort()
    founders = (f0, f1)
    return {"launches": launches, "step_ms_p50": 1e3 * step_s[len(step_s) // 2],
            "step_ms_all": [round(1e3 * s, 3) for s in step_s],
            # whole timed window (first dispatch to the flush's settle)
            # over its steps, per founder: the throughput a user sees
            "window_ms_per_step": [
                round(1e3 * r["phases"]["q8"]["window_s"]
                      / r["phases"]["q8"]["dispatches"], 3) for r in founders],
            "warm_step_ms": [[round(1e3 * x, 3) for x in
                              r["phases"]["warm"]["step_s"]] for r in founders],
            "warm_timers_ms": f0["phases"]["warm"]["timers_ms"],
            "q8_timers_ms": f0["phases"]["q8"]["timers_ms"],
            "compute_ms": [round(1e3 * s, 3) for s in compute_s],
            "heal_fetch_s": late["fetch"]["fetch_s"],
            "trace": f0.get("trace"),
            "ring_split": _ring_split(f0["phases"]["q8"]["op_stats"]),
            "signals": f0["phases"]["q8"]["signals"]}


def _run_groups(workdir: str, base: dict, labels: list) -> dict:
    """One worker per entry of ``labels`` (its region and host), all
    started at once against an in-process lighthouse that waits for all
    of them."""
    import torchft_tpu_torch as tft

    n = len(labels)
    lighthouse = tft.Lighthouse(min_replicas=n, join_timeout_ms=10000,
                                quorum_tick_ms=50, heartbeat_timeout_ms=10000)
    t0 = time.perf_counter()
    procs = []
    try:
        procs = [_spawn({**base, "lighthouse": lighthouse.address(),
                         "workdir": workdir, "data_offset": 0, "group": g,
                         "groups": n, **labels[g]}, workdir)
                 for g in range(n)]
        _join(procs, time.monotonic() + 600, workdir)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        lighthouse.shutdown()
    results = []
    for g in range(n):
        with open(os.path.join(workdir, f"result_{g}.json")) as f:
            results.append(json.load(f))
    return {"results": results, "total_s": time.perf_counter() - t0}


def phase_flash_train(workdir: str, device: str = "cuda", lm: dict = BIG_LM,
                      batch: int = BIG_BATCH, seq: int = BIG_SEQ,
                      hier: bool = False) -> dict:
    """Two groups on the big LM; ``hier``: both labeled with one host, on
    PipelinedDDP(hier=True) (the shm host tier)."""
    base = {"device": device, "role": "hier_flash" if hier else "flash",
            "lm": lm, "batch": batch, "seq": seq}
    labels = [{"host": HIER_HOST} if hier else {} for _ in range(2)]
    return _run_groups(workdir, base, labels)


def phase_hier_dense(workdir: str, device: str = "cuda", lm: dict = LM,
                     batch: int = BATCH, seq: int = SEQ) -> dict:
    """Four groups on the dense LM in two regions of two co-hosted groups:
    the shm host tier and the inter-region ring (its q8ef wire) both run."""
    base = {"device": device, "role": "hier_dense", "lm": lm,
            "batch": batch, "seq": seq}
    return _run_groups(workdir, base, [{"region": r, "host": h}
                                       for r, h in HIER_DENSE_LABELS])


def _expected_host_transport() -> str:
    off = os.environ.get("TORCHFT_HC_SHM", "").lower() in ("0", "off", "false")
    return "tcp" if off else "shm"


def _check_topology(results, label: str) -> None:
    want = _expected_host_transport()
    for r in results:
        topo = r["topology"]
        if not topo["hier_capable"]:
            fail(f"{label} group {r['group']} is not hier-capable: {topo}")
        if topo["host_tier_transport"] != want:
            fail(f"{label} group {r['group']}: host tier "
                 f"{topo['host_tier_transport']}, expected {want}: {topo}")


def check_flash_training(res: dict, expect_leaves: int = 51,
                         on_card: bool = True, hier: bool = False) -> dict:
    label = "hier flash" if hier else "flash"
    results = res["results"]
    if hier:
        _check_topology(results, label)
    launches = {}
    step_s = []
    for r in results:
        g, n_leaves, n_layers = r["group"], r["n_leaves"], r["n_layers"]
        if n_leaves != expect_leaves:
            fail(f"{label} group {g}: {n_leaves} leaves")
        for phase, ph in r["phases"].items():
            if not all(ph["commits"]) or not ph["commits"]:
                fail(f"{label} group {g} {phase}: uncommitted step {ph['commits']}")
            if not all(map(_finite, ph["losses"])):
                fail(f"{label} group {g} {phase}: non-finite loss {ph['losses']}")
            # a forward/backward pass per step, and one more for a step
            # whose gradients a heal made stale (the manager's first
            # quorum heals group 1 from group 0: its init sync)
            steps, passes = ph["dispatches"], ph["grad_passes"]
            if passes != steps + sum(ph["heals"].values()):
                fail(f"{label} group {g} {phase}: {passes} passes for {steps} "
                     f"steps and heals {ph['heals']}")
            want = dict.fromkeys(ph["launches"], 0)
            if on_card:
                want.update(flash_fwd=n_layers * passes,
                            flash_bwd=2 * n_layers * passes)
                if not hier:  # one plan group per step; the hier pack is native
                    want.update(q8_absmax=steps, q8_quantize=steps)
            if ph["launches"] != want:
                fail(f"{label} group {g} {phase}: launches {ph['launches']} "
                     f"!= {want}")
            for k, n in ph["launches"].items():
                launches[k] = launches.get(k, 0) + n
            log(f"  {label} group {g} {phase}: {steps} steps committed, step "
                f"{ph['step']}, {passes} forward/backward passes (heals "
                f"{ph['heals']}), losses {[round(l, 4) for l in ph['losses']]}"
                f", launches {ph['launches']}")
        step_s += r["phases"]["flash"]["step_s"][1:]
    f0, f1 = results
    for phase in ("warm", "flash", "traced"):
        if f0["phases"][phase]["digest"] != f1["phases"][phase]["digest"]:
            fail(f"{label} founders' parameters differ after the {phase} phase")
    traced = [k["name"] for k in (f0.get("trace") or {}).get("flash_kernels", [])]
    missing = [k for k in MMA_KERNELS if not any(k in n for n in traced)]
    if on_card and missing:
        fail(f"the traced {label} steps show no {missing} (flash kernels: "
             f"{traced})")
    if on_card and not (f0.get("trace") or {}).get("ring_windows_ms"):
        fail(f"the {label} trace shows no ring window: {f0.get('trace')}")
    fvd = f0.get("flash_vs_dense")
    if fvd is not None:
        rel = abs(fvd["flash"] - fvd["dense"]) / abs(fvd["dense"])
        if not (_finite(fvd["flash"]) and rel <= FLASH_DENSE_LOSS_RTOL):
            fail(f"flash loss {fvd['flash']} vs dense {fvd['dense']}: rel "
                 f"{rel:.3g} > {FLASH_DENSE_LOSS_RTOL:.3g}")
        fvd = {**fvd, "rel": rel}
    elif not hier:
        fail("group 0 of the flash phase held no flash loss against dense")
    rows = f0["phases"]["flash"]["op_stats"]
    if len(rows) != f0["phases"]["flash"]["dispatches"]:
        fail(f"{label}: {len(rows)} op-stats entries for "
             f"{f0['phases']['flash']['dispatches']} steps")
    if hier and any(r.get("py_staging_allocs") for r in rows):
        fail(f"{label}: the hier plan allocated staging after warm-up: {rows}")
    step_s.sort()
    timers = f0["phases"]["flash"]["timers_ms"]
    return {
        "launches": launches,
        "step_ms_p50": 1e3 * step_s[len(step_s) // 2],
        "step_ms_all": [round(1e3 * s, 3) for s in step_s],
        "window_ms_per_step": [
            round(1e3 * r["phases"]["flash"]["window_s"]
                  / r["phases"]["flash"]["dispatches"], 3) for r in results],
        "plan_allreduce_ms": timers.get("plan_allreduce", {}).get("mean"),
        "timers_ms": timers,
        "compute_ms": [round(1e3 * r["compute_s"], 3) for r in results],
        "max_memory_allocated_gb": [
            round(r.get("max_memory_allocated", 0) / 2**30, 3) for r in results],
        "step_start_allocated_gb": [
            [round(b / 2**30, 3) for b in r["phases"]["flash"]["mem_start"]]
            for r in results],
        "flash_vs_dense": fvd,
        "trace": f0.get("trace"),
        "ring_split": _ring_split(rows),
        "signals": f0["phases"]["flash"]["signals"],
        "topology": f0["topology"],
    }


def check_hier_dense(res: dict, expect_leaves: int = 39,
                     on_card: bool = True) -> dict:
    results = res["results"]
    _check_topology(results, "hier dense")
    for r in results:
        g = r["group"]
        if r["n_leaves"] != expect_leaves:
            fail(f"hier dense group {g}: {r['n_leaves']} leaves")
        for phase, ph in r["phases"].items():
            if not all(ph["commits"]) or not ph["commits"]:
                fail(f"hier dense group {g} {phase}: uncommitted step "
                     f"{ph['commits']}")
            if not all(map(_finite, ph["losses"])):
                fail(f"hier dense group {g} {phase}: non-finite loss "
                     f"{ph['losses']}")
            if any(ph["launches"].values()):  # dense attention, native pack
                fail(f"hier dense group {g} {phase}: launches {ph['launches']}")
            log(f"  hier dense group {g} {phase}: {ph['dispatches']} steps "
                f"committed, step {ph['step']}, losses "
                f"{[round(l, 4) for l in ph['losses']]}")
    for phase in ("warm", "hier"):
        digests = {r["phases"][phase]["digest"] for r in results}
        if len(digests) != 1:
            fail(f"hier dense groups differ after the {phase} phase")
    # the inter tier's bill: a leader of each region ships its region's
    # sum over a 2-member q8ef ring, (L-1)/L of the int8 codes per phase,
    # twice: about one byte per parameter, a quarter of the f32 bill
    split = {}
    for r in results:
        rows = r["phases"]["hier"]["op_stats"]
        if not rows:
            fail(f"hier dense group {r['group']}: no op stats")
        n_params = rows[0]["bytes"] // 4
        tx = _median([x["inter_tx_bytes"] for x in rows])
        leader = rows[0]["inter_leader"]
        if leader and not 0.9 * n_params <= tx <= 1.25 * n_params:
            fail(f"hier dense group {r['group']}: the inter tier sent {tx} B "
                 f"per step for {n_params} params (q8 wire ~{n_params} B, "
                 f"f32 {4 * n_params} B)")
        if not leader and tx != 0:
            fail(f"hier dense group {r['group']} leads no region but sent "
                 f"{tx} B on the inter tier")
        split[r["group"]] = {**_ring_split(rows), "inter_leader": leader,
                             "q8_wire_bytes_per_step": n_params,
                             "f32_bytes": 4 * n_params}
    return {"split": split, "topology": [r["topology"] for r in results],
            "signals": results[0]["phases"]["hier"]["signals"],
            "window_ms_per_step": [
                round(1e3 * r["phases"]["hier"]["window_s"]
                      / r["phases"]["hier"]["dispatches"], 3)
                for r in results]}


# -- heal transport at the flash LM's state size -------------------------------

def phase_legacy(workdir: str, device: str = "cuda", lm: dict = LM,
                 batch: int = BATCH, seq: int = SEQ) -> dict:
    """Two groups on the dense LM: PipelinedDDP(transport="legacy") in
    every compress mode beside the plan transport's q8, then broadcast,
    barrier and DummyCollectives."""
    base = {"device": device, "role": "legacy", "lm": lm, "batch": batch,
            "seq": seq}
    return _run_groups(workdir, base, [{}, {}])


def check_legacy(res: dict, on_card: bool = True) -> dict:
    results = res["results"]
    groups = len(results)
    launches: dict = {}
    for r in results:
        g = r["group"]
        for phase, ph in r["phases"].items():
            if not all(ph["commits"]) or not ph["commits"]:
                fail(f"legacy group {g} {phase}: uncommitted step {ph['commits']}")
            if not all(map(_finite, ph["losses"])):
                fail(f"legacy group {g} {phase}: non-finite loss {ph['losses']}")
            n = ph["dispatches"]
            want = dict.fromkeys(ph["launches"], 0)
            mode = phase.replace("_warm", "")
            if on_card:
                if mode.startswith("plan") or mode in ("q8", "int8"):
                    want.update(q8_absmax=n, q8_quantize=n)
                if mode == "q8":  # dq of the quantize pack
                    want["q8_dequantize"] = n
                if mode == "int8":  # dq, and each member's entry at settle
                    want["q8_dequantize"] = n * (1 + groups)
                if mode == "bf16":
                    want["cast_bf16"] = n
            if ph["launches"] != want:
                fail(f"legacy group {g} {phase}: launches {ph['launches']} "
                     f"!= {want}")
            if not mode.startswith("plan"):
                for k, v in ph["launches"].items():
                    launches[k] = launches.get(k, 0) + v
    for phase in results[0]["phases"]:
        digests = {r["phases"][phase]["digest"] for r in results}
        if len(digests) != 1:
            fail(f"legacy groups' parameters differ after the {phase} phase")
    ops = [r["plane_ops"] for r in results]
    root = next(o["sent"] for o in ops if o["rank"] == 0)
    for o in ops:
        if not (o["broadcast"] == root and o["broadcast_uniform"]
                and o["broadcast_on_device"] and o["dummy_ok"]):
            fail(f"broadcast/barrier/DummyCollectives: {ops}")
    r0 = results[0]["phases"]
    split = {}
    for mode in ("plan_q8",) + tuple(m or "f32" for m in LEGACY_MODES):
        steps = sorted(s for r in results for s in r["phases"][mode]["step_s"][1:])
        blocking = sorted(s for r in results
                          for s in r["phases"][mode]["blocking_s"])
        split[mode] = {
            "step_ms_p50": round(1e3 * steps[len(steps) // 2], 3),
            "step_ms_all": [round(1e3 * x, 3) for x in steps],
            "blocking_ms": [round(1e3 * x, 3) for x in blocking],
            "ops": r0[mode]["op_split"],
            "launches": r0[mode]["launches"],
        }
        if mode == "plan_q8":
            split[mode]["ring_split"] = _ring_split(r0[mode]["op_stats"])
    return {"launches": launches, "modes": split, "plane_ops": ops}


def phase_sharded_flash(workdir: str, device: str = "cuda",
                        lm: dict = BIG_LM, batch: int = BIG_BATCH,
                        seq: int = BIG_SEQ) -> dict:
    """Two groups on the big LM through ShardedOptimizerWrapper
    (shard_wire="q8", so param_wire="bf16")."""
    base = {"device": device, "role": "sharded_flash", "lm": lm,
            "batch": batch, "seq": seq, "shard_wire": "q8"}
    return _run_groups(workdir, base, [{}, {}])


def _check_tiles(label: str, metas: list, total: int) -> None:
    """The members' ranges cover [0, total) exactly once."""
    spans = sorted((s, n) for ranges in metas for s, n in ranges)
    at = 0
    for s, n in spans:
        if s != at:
            fail(f"{label}: shards do not tile the model at {at}: {spans}")
        at = s + n
    if at != total:
        fail(f"{label}: shards cover {at} of {total} elements")


def check_sharded_flash(res: dict, on_card: bool = True,
                        full_bytes: int = FLASH_ADAMW_BYTES) -> dict:
    results = res["results"]
    launches: dict = {}
    for r in results:
        g, layers = r["group"], r["n_layers"]
        for phase, ph in r["phases"].items():
            if not all(ph["commits"]) or not ph["commits"]:
                fail(f"sharded group {g} {phase}: uncommitted step {ph['commits']}")
            if not all(map(_finite, ph["losses"])):
                fail(f"sharded group {g} {phase}: non-finite loss {ph['losses']}")
            n = ph["dispatches"]
            want = dict.fromkeys(ph["launches"], 0)
            if on_card:  # the sharded plan packs natively: no wire kernel
                want.update(flash_fwd=layers * n, flash_bwd=2 * layers * n)
            if ph["launches"] != want:
                fail(f"sharded group {g} {phase}: launches {ph['launches']} "
                     f"!= {want}")
            for k, v in ph["launches"].items():
                launches[k] = launches.get(k, 0) + v
    for phase in results[0]["phases"]:
        for step, ds in enumerate(zip(*[r["phases"][phase]["digests"]
                                        for r in results])):
            if len(set(ds)) != 1:
                fail(f"sharded groups differ after {phase} step {step}")
    last = [r["phases"]["sharded"] for r in results]
    _check_tiles("sharded flash", [ph["ranges"] for ph in last],
                 results[0]["total"])
    opt_bytes = [ph["opt_state_bytes"] for ph in last]
    if sum(opt_bytes) != full_bytes or any(
            abs(b - full_bytes / 2) > 0.01 * full_bytes for b in opt_bytes):
        fail(f"sharded optimizer state {opt_bytes} B is not half of "
             f"{full_bytes} B per group")
    steps = sorted(s for ph in last for s in ph["step_s"])
    return {
        "launches": launches,
        "step_ms_p50": round(1e3 * steps[len(steps) // 2], 3),
        "step_ms_all": [round(1e3 * x, 3) for x in steps],
        "opt_state_bytes": opt_bytes,
        "max_memory_allocated_gb": [
            round(r.get("max_memory_allocated", 0) / 2**30, 3) for r in results],
        "ops": last[0]["op_split"],
        "timers_ms": last[0]["timers_ms"],
    }


def phase_reshard(workdir: str, device: str = "cuda", lm: dict = LM,
                  batch: int = BATCH, seq: int = SEQ) -> dict:
    """Two founders on the dense LM through ShardedOptimizerWrapper
    (shard_wire="q8"), then a third group joins: it heals the wrapper's
    state (shard and meta) and all three re-partition the optimizer
    state through the mask allgather."""
    import torchft_tpu_torch as tft

    lighthouse = tft.Lighthouse(min_replicas=2, join_timeout_ms=10000,
                                quorum_tick_ms=50, heartbeat_timeout_ms=10000)
    base = {"lighthouse": lighthouse.address(), "workdir": workdir,
            "data_offset": 0, "device": device, "lm": lm, "batch": batch,
            "seq": seq, "shard_wire": "q8"}
    t0 = time.perf_counter()
    procs = []
    try:
        procs = [_spawn({**base, "group": g, "role": "reshard"}, workdir)
                 for g in (0, 1)]
        deadline = time.monotonic() + 600
        for g in (0, 1):
            path = os.path.join(workdir, f"ready_{g}")
            while not os.path.exists(path):
                if any(p.poll() not in (None, 0) for p in procs):
                    _join(procs, deadline, workdir)
                if time.monotonic() > deadline:
                    fail("reshard founders never finished their steps")
                time.sleep(0.1)
        procs.append(_spawn({**base, "group": 2, "role": "reshard_late"},
                            workdir))
        _join(procs, deadline, workdir)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        lighthouse.shutdown()
    results = []
    for g in (0, 1, 2):
        with open(os.path.join(workdir, f"result_{g}.json")) as f:
            results.append(json.load(f))
    return {"results": results, "total_s": time.perf_counter() - t0}


def check_reshard(res: dict) -> dict:
    """The founders commit their steps; the joiner heals the wrapper's
    state over the stream; the step of the first three-member quorum may
    be discarded (the joiner, healing, holds no shard to scatter until
    its heal applies at the vote), and every step after it commits; all
    three end bit-identical, on one quorum's partition, their shards
    tiling the model and each covering its ranges."""
    results = res["results"]
    f0, f1, late = results
    for r in (f0, f1):
        ph = r["phases"]["founders"]
        if not all(ph["commits"]) or not ph["commits"]:
            fail(f"reshard founder {r['group']}: uncommitted {ph['commits']}")
    joins = [r["phases"]["join"] for r in results]
    for r, ph in zip(results, joins):
        tail = ph["commits"][-RESHARD_STEPS:]
        if len(tail) < RESHARD_STEPS or not all(tail):
            fail(f"reshard group {r['group']}: the last steps did not commit: "
                 f"{ph['commits']}")
        if ph["commits"].count(False) > 1:
            fail(f"reshard group {r['group']}: more than the join step "
                 f"discarded: {ph['commits']}")
        if not all(map(_finite, ph["losses"])):
            fail(f"reshard group {r['group']}: non-finite loss {ph['losses']}")
        if ph["world"] != 3:
            fail(f"reshard group {r['group']} ended in a ring of {ph['world']}")
        if ph["opt_numel"] != sum(n for _, n in ph["ranges"]):
            fail(f"reshard group {r['group']}: shard of {ph['opt_numel']} for "
                 f"ranges {ph['ranges']}")
    if (late.get("fetch") or {}).get("path") != "stream":
        fail(f"the joiner did not heal over the stream: {late.get('fetch')}")
    if sum(joins[2]["heals"].values()) < 1:
        fail(f"the joiner never healed: {joins[2]['heals']}")
    if len({ph["digests"][-1] for ph in joins}) != 1:
        fail("reshard groups' parameters differ at the end")
    if len({ph["quorum_id"] for ph in joins}) != 1:
        fail(f"reshard groups on different partitions: "
             f"{[ph['quorum_id'] for ph in joins]}")
    _check_tiles("reshard", [ph["ranges"] for ph in joins], f0["total"])
    return {"commits": [ph["commits"] for ph in joins],
            "opt_state_bytes": [ph["opt_state_bytes"] for ph in joins],
            "fetch": late["fetch"],
            "ops": joins[0]["op_split"]}


def phase_diloco_flash(workdir: str, device: str = "cuda", lm: dict = BIG_LM,
                       batch: int = BIG_BATCH, seq: int = BIG_SEQ) -> dict:
    """Two groups on the big LM: bare inner steps, AsyncDiLoCo in each of
    DILOCO_MODES, then sharded DiLoCo (q8 shard wire, bf16 param wire)."""
    base = {"device": device, "role": "diloco_flash", "lm": lm,
            "batch": batch, "seq": seq}
    return _run_groups(workdir, base, [{}, {}])


def _flash_want(r: dict, steps: int, on_card: bool, lm: dict) -> dict:
    if not (on_card and lm.get("use_flash")):
        return {}
    return {"flash_fwd": r["n_layers"] * steps,
            "flash_bwd": 2 * r["n_layers"] * steps}


def _p50(xs) -> float:
    xs = sorted(xs)
    return round(1e3 * xs[len(xs) // 2], 3)


def check_async_diloco(res: dict, on_card: bool = True,
                       lm: dict = BIG_LM) -> dict:
    """Every sync commits; the groups' backups are bit-identical after
    every committed sync; under overlap=False each group's params sit
    within its EF residual's change of that backup (the reconcile
    θ + (G' − (B − dq)) keeps the per-group residual, so params are
    cohort-identical only up to it, as in the JAX package); each mode
    launches exactly its kernels: K3 once a bf16 sync, K1a/K1b/K2 once an
    int8/q8 sync (int8: K2 once more per member at the finish), K4/K5
    on every inner step."""
    results = res["results"]
    n_syncs = DILOCO_WARM_WINDOWS + DILOCO_WINDOWS
    launches: dict = {}
    modes: dict = {}
    raw = sorted(s for r in results for s in r["raw_step_s"])
    raw_p50 = _p50(raw)
    for compress, overlap in DILOCO_MODES:
        name = f"async_{compress}"
        recs = [r["phases"][name] for r in results]
        for r, rec in zip(results, recs):
            g = r["group"]
            if rec["commits"] != [True] * n_syncs:
                fail(f"async diloco {compress} group {g}: syncs "
                     f"{rec['commits']}")
            want = dict.fromkeys(rec["launches"], 0)
            want.update(_flash_want(r, rec["inner_steps"], on_card, lm))
            if on_card:
                if compress == "bf16":
                    want["cast_bf16"] = n_syncs
                else:
                    want["q8_absmax"] = want["q8_quantize"] = n_syncs
                    want["q8_dequantize"] = n_syncs * (
                        1 + len(results) if compress == "int8" else 1)
            if rec["launches"] != want:
                fail(f"async diloco {compress} group {g}: launches "
                     f"{rec['launches']} != {want}")
            for k, v in rec["launches"].items():
                launches[k] = launches.get(k, 0) + v
            if not overlap:
                res_max = [0.0] + rec["residual_max"]
                for i, dev in enumerate(rec["theta_dev"]):
                    bound = (res_max[i] + res_max[i + 1]
                             + 4e-6 * max(1.0, rec["theta_max"]))
                    if not dev <= bound:
                        fail(f"async diloco {compress} group {g} sync {i}: "
                             f"params {dev} from the backup, beyond the EF "
                             f"bound {bound}")
        if recs[0]["backups"] != recs[1]["backups"]:
            fail(f"async diloco {compress}: backups differ across groups")
        steps = [s for rec in recs for s in rec["step_s"]]
        window = [round(1e3 * rec["window_s"]
                        / (DILOCO_WINDOWS * DILOCO_SYNC_EVERY), 3)
                  for rec in recs]
        modes[f"{compress} overlap={overlap}"] = {
            "inner_step_ms_p50": _p50(steps),
            "sync_launch_ms": [[round(1e3 * x, 3) for x in rec["launch_s"]]
                               for rec in recs],
            "sync_finish_ms": [[round(1e3 * x, 3) for x in rec["finish_s"]]
                               for rec in recs],
            "window_ms_per_inner_step": window,
            "ft_over_raw": [round(w / raw_p50, 4) for w in window],
            "launches": recs[0]["launches"],
            "timers_ms": recs[0]["timers_ms"],
            "theta_dev": recs[0].get("theta_dev"),
        }
    return {"launches": launches, "modes": modes, "raw_step_ms_p50": raw_p50,
            "raw_step_ms_all": [round(1e3 * x, 3) for x in raw],
            "max_memory_allocated_gb": [
                round(r.get("max_memory_allocated", 0) / 2**30, 3)
                for r in results]}


def check_sharded_diloco(res: dict, on_card: bool = True, lm: dict = BIG_LM,
                         outer_bytes: int = SHARDED_OUTER_BYTES) -> dict:
    """Every sync commits with params bit-identical across the groups;
    each group's outer momentum is half of the f32 model (W = 2) and the
    shards tile it; per sync K1a/K1b/K2 (the q8 EF delta) and K3 (the
    bf16 param leg) launch once, K4/K5 on every inner step."""
    results = res["results"]
    recs = [r["phases"]["sharded"] for r in results]
    launches: dict = {}
    for r, rec in zip(results, recs):
        g = r["group"]
        if rec["commits"] != [True] * SHARDED_DILOCO_WINDOWS:
            fail(f"sharded diloco group {g}: syncs {rec['commits']}")
        want = dict.fromkeys(rec["launches"], 0)
        want.update(_flash_want(r, rec["inner_steps"], on_card, lm))
        if on_card:
            for k in ("q8_absmax", "q8_quantize", "q8_dequantize",
                      "cast_bf16"):
                want[k] = SHARDED_DILOCO_WINDOWS
        if rec["launches"] != want:
            fail(f"sharded diloco group {g}: launches {rec['launches']} "
                 f"!= {want}")
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
        if rec["outer_bytes"] != outer_bytes:
            fail(f"sharded diloco group {g}: outer momentum "
                 f"{rec['outer_bytes']} B, not {outer_bytes} B")
    if recs[0]["digests"] != recs[1]["digests"]:
        fail("sharded diloco: params differ across groups after a sync")
    _check_tiles("sharded diloco", [rec["ranges"] for rec in recs],
                 results[0]["total"])
    return {"launches": launches,
            "inner_step_ms_p50": _p50([s for rec in recs
                                       for s in rec["step_s"]]),
            "sync_ms": [[round(1e3 * x, 3) for x in rec["sync_s"]]
                        for rec in recs],
            "outer_bytes": [rec["outer_bytes"] for rec in recs],
            "ops": recs[0]["op_split"]}


def phase_diloco_reshard(workdir: str, device: str = "cuda", lm: dict = LM,
                         batch: int = BATCH, seq: int = SEQ) -> dict:
    """Two founders on the dense LM through sharded DiLoCo (q8, bf16),
    then a third group joins: its first start_quorum heals it (a
    synchronous quorum) and it takes part in that sync, where all three
    re-partition the outer state."""
    import torchft_tpu_torch as tft

    lighthouse = tft.Lighthouse(min_replicas=2, join_timeout_ms=10000,
                                quorum_tick_ms=50, heartbeat_timeout_ms=10000)
    base = {"lighthouse": lighthouse.address(), "workdir": workdir,
            "data_offset": 0, "device": device, "lm": lm, "batch": batch,
            "seq": seq, "groups": 2}
    t0 = time.perf_counter()
    procs = []
    try:
        procs = [_spawn({**base, "group": g, "role": "diloco_reshard"},
                        workdir) for g in (0, 1)]
        deadline = time.monotonic() + 600
        for g in (0, 1):
            path = os.path.join(workdir, f"ready_{g}")
            while not os.path.exists(path):
                if any(p.poll() not in (None, 0) for p in procs):
                    _join(procs, deadline, workdir)
                if time.monotonic() > deadline:
                    fail("diloco reshard founders never finished")
                time.sleep(0.1)
        procs.append(_spawn({**base, "group": 2,
                             "role": "diloco_reshard_late"}, workdir))
        _join(procs, deadline, workdir)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        lighthouse.shutdown()
    results = []
    for g in (0, 1, 2):
        with open(os.path.join(workdir, f"result_{g}.json")) as f:
            results.append(json.load(f))
    return {"results": results, "total_s": time.perf_counter() - t0}


def check_diloco_reshard(res: dict, on_card: bool = True) -> dict:
    """Every sync commits, the joiner's first included (it healed in its
    start_quorum and took part); the joiner healed over the stream; all
    three end bit-identical on one quorum's partition, their outer
    shards tiling the model; K1a/K1b/K2/K3 once per sync."""
    results = res["results"]
    recs = [r["phases"]["reshard"] for r in results]
    launches: dict = {}
    for r, rec in zip(results, recs):
        g = r["group"]
        if not rec["commits"] or not all(rec["commits"]):
            fail(f"diloco reshard group {g}: syncs {rec['commits']}")
        if rec["world"][-DILOCO_RESHARD_WINDOWS:] != [3] * DILOCO_RESHARD_WINDOWS:
            fail(f"diloco reshard group {g}: worlds {rec['world']}")
        if rec["outer_numel"] != sum(n for _, n in rec["ranges"]):
            fail(f"diloco reshard group {g}: outer shard of "
                 f"{rec['outer_numel']} for ranges {rec['ranges']}")
        want = dict.fromkeys(rec["launches"], 0)
        if on_card:
            for k in ("q8_absmax", "q8_quantize", "q8_dequantize",
                      "cast_bf16"):
                want[k] = len(rec["commits"])
        if rec["launches"] != want:
            fail(f"diloco reshard group {g}: launches {rec['launches']} "
                 f"!= {want}")
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
    late = recs[2]
    if (late.get("fetch") or {}).get("path") != "stream":
        fail(f"the diloco joiner did not heal over the stream: "
             f"{late.get('fetch')}")
    if sum(late["heals"].values()) < 1:
        fail(f"the diloco joiner never healed: {late['heals']}")
    if len({rec["digests"][-1] for rec in recs}) != 1:
        fail("diloco reshard groups' params differ at the end")
    if len({rec["quorum_id"] for rec in recs}) != 1:
        fail(f"diloco reshard groups on different partitions: "
             f"{[rec['quorum_id'] for rec in recs]}")
    _check_tiles("diloco reshard", [rec["ranges"] for rec in recs],
                 results[0]["total"])
    return {"launches": launches, "commits": [rec["commits"] for rec in recs],
            "worlds": [rec["world"] for rec in recs], "fetch": late["fetch"]}


ADAPTIVE_CANDIDATES = ["blocking", "plan", "plan_devpack", "plan_hier",
                       "pipelined", "ddp_sharded"]


def phase_adaptive_flash(workdir: str, device: str = "cuda",
                         lm: dict = BIG_LM, batch: int = BIG_BATCH,
                         seq: int = BIG_SEQ) -> dict:
    """Two groups on the big LM through AdaptiveDDP(compress="q8") with
    all six candidates in the race."""
    base = {"device": device, "role": "adaptive_flash", "lm": lm,
            "batch": batch, "seq": seq,
            "env": {"TORCHFT_DEVICE_PACK": "auto",
                    "TORCHFT_HOST": ADAPTIVE_HOST,
                    "TORCHFT_DDP_SHARDED": "1"}}
    return _run_groups(workdir, base, [{}, {}])


def check_adaptive(res: dict, on_card: bool = True, lm: dict = BIG_LM) -> dict:
    """Both groups race the same six candidates, record no failure
    sentinel, lock the same mode on the same decision and end
    bit-identical; every transaction committed; K1a/K1b/K2 launched (the
    legacy q8 and the device pack), K4/K5 once per gradient pass."""
    results = res["results"]
    launches: dict = {}
    for r in results:
        g = r["group"]
        if r["candidates"] != ADAPTIVE_CANDIDATES:
            fail(f"adaptive group {g}: candidates {r['candidates']}")
        probe = (r["decision"] or {}).get("probe_s") or {}
        if set(probe) != set(ADAPTIVE_CANDIDATES) or any(
                v >= 1e9 for v in probe.values()):
            fail(f"adaptive group {g}: a candidate failed: {r['decision']}")
        if r["committed"] != r["steps"]:
            fail(f"adaptive group {g}: {r['committed']} of {r['steps']} "
                 "transactions committed")
        if not all(map(_finite, r["losses"])):
            fail(f"adaptive group {g}: non-finite loss {r['losses']}")
        if not r["topology"]["hier_capable"]:
            fail(f"adaptive group {g}: the cohort is not hier-capable")
        want = dict.fromkeys(r["launches"], 0)
        want.update(_flash_want(r, r["grad_passes"], on_card, lm))
        got = dict(r["launches"])
        if on_card:
            for k in ("q8_absmax", "q8_quantize", "q8_dequantize"):
                if got.get(k, 0) < 1:
                    fail(f"adaptive group {g}: {k} never launched: {got}")
                want[k] = got[k]
        if got != want:
            fail(f"adaptive group {g}: launches {got} != {want}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    d0, d1 = results[0]["decision"], results[1]["decision"]
    if d0 != d1 or results[0]["mode"] != results[1]["mode"]:
        fail(f"adaptive groups locked differently: {d0} vs {d1}")
    if results[0]["digest"] != results[1]["digest"]:
        fail("adaptive groups' params differ after the flush")
    return {"launches": launches, "decision": d0, "mode": results[0]["mode"],
            "modes": results[0]["modes"],
            "step_ms": [[round(1e3 * x, 3) for x in r["step_s"]]
                        for r in results],
            "topology": results[0]["topology"]}


HEAL_STEP = 5          # the step the heal donor publishes
HEAL_SEED = 17         # the donor's moments (params: init_params seed 0)
# (label, path, wire, streams) of each fetch of the heal transport phase
# (each wire's first fetch builds the donor's staging and the receiver's
# pinned buffer of that size: "cold"; the same fetch again: "warm")
HEAL_FETCHES = [("stream none x1 cold", "stream", None, 1),
                ("stream none x1 warm", "stream", None, 1),
                ("stream none x4", "stream", None, 4),
                ("stream bf16 x1 cold", "stream", "bf16", 1),
                ("stream bf16 x1 warm", "stream", "bf16", 1),
                ("stream bf16 x4", "stream", "bf16", 4),
                ("striped x4", "striped", None, 4),
                ("single", "single", None, 1)]


def _heal_state(lm: dict, device: torch.device) -> dict:
    """The heal payload of one group of ``lm``: its f32 params (seed 0),
    AdamW moments drawn from HEAL_SEED (on the CPU, then moved: the same
    bits in every process), and the manager's counters."""
    from torchft_tpu_torch._tree import tree_map
    from torchft_tpu_torch.models import transformer as tt

    params = tt.init_params(tt.TransformerConfig(**lm), seed=0, device=device)
    gen = torch.Generator().manual_seed(HEAL_SEED)

    def moment(p: torch.Tensor, scale: float) -> torch.Tensor:
        return (torch.randn(p.shape, generator=gen) * scale).to(device)

    mu = tree_map(lambda p: moment(p, 1e-3), params)
    nu = tree_map(lambda p: moment(p, 1e-3).square(), params)
    return {"user": {"params": params,
                     "opt_state": {"count": HEAL_STEP, "mu": mu, "nu": nu}},
            "torchft": {"step": HEAL_STEP, "batches_committed": 2 * HEAL_STEP}}


def heal_donor(cfg: dict) -> None:
    """The donor of the heal transport phase, in a process of its own (so
    its server threads and the receiver's readers hold two GILs):
    publishes the state, prints its address, serves until its standard
    input says the receiver is done, then prints its launch counts."""
    from datetime import timedelta

    import torchft_tpu_torch as tft
    from torchft_tpu_torch.ops import quantize_kernels as qk

    device = torch.device(cfg["device"])
    state = _heal_state(cfg["lm"], device)
    server = tft.CheckpointServer(timeout=timedelta(seconds=300), device=device)
    try:
        server.send_checkpoint([1], HEAL_STEP, state, timedelta(seconds=300))
        qk.reset_launch_counts()
        print(json.dumps({"address": server.address()}), flush=True)
        sys.stdin.readline()
        launches = dict(qk.launch_counts)
        # the CRC32C a range header costs before its first byte: the
        # native CRC over the whole raw staging, on this host's CPU
        raw = server._stagings[None]
        t0 = time.perf_counter()
        raw.range_crc32c(0, raw.total)
        print(json.dumps({
            "launches": launches,
            "staging_build_s": {str(w): st.build_s
                                for w, st in server._stagings.items()},
            "crc_s": time.perf_counter() - t0}), flush=True)
    finally:
        server.shutdown()


def _json_line(stream) -> dict:
    for line in stream:
        if line.startswith("{"):
            return json.loads(line)
    fail("the heal donor exited without answering")


def _heal_fetch(ck, address: str, path: str, wire, streams: int,
                device: torch.device):
    """One fetch by ``path``: the tree and its stats. The pickled paths
    return host numpy leaves; their ``h2d_s`` is the upload of those
    leaves onto ``device`` afterwards (what the caller's load_state_dict
    pays), the stream's the upload left once the last byte arrived."""
    import urllib.request
    from datetime import timedelta

    from torchft_tpu_torch._tree import tree_map

    timeout = timedelta(seconds=300)
    if path == "stream":
        return ck.CheckpointServer._load_stream(address, timeout, wire,
                                                streams, device)
    t0 = time.perf_counter()
    if path == "striped":
        out = ck.CheckpointServer._load_striped(address, timeout, streams)
    else:
        with urllib.request.urlopen(address, timeout=300) as f:
            out = ck.load_state_dict_stream(f)
    fetch_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    out = tree_map(lambda l: torch.from_numpy(l).to(device, non_blocking=True)
                   if isinstance(l, np.ndarray) else l, out)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, {"path": path, "wire": None, "streams": streams,
                 "fetch_s": fetch_s, "h2d_s": time.perf_counter() - t1}


def _check_healed(label: str, out: dict, ref: dict, wire) -> int:
    """Params bit-identical to the donor's; moments bit-identical on the
    raw wire, K3's plain cast of the donor's on the bf16 wire. Returns the
    array bytes checked."""
    from torchft_tpu_torch._tree import flatten
    from torchft_tpu_torch.ops import quantize_kernels as qk

    n = 0
    got_p, want_p = flatten(out["user"]["params"])[0], flatten(ref["user"]["params"])[0]
    if len(got_p) != len(want_p):
        fail(f"heal {label}: {len(got_p)} param leaves, donor {len(want_p)}")
    for g, w in zip(got_p, want_p):
        if g.device != w.device or not _bits_equal(g, w):
            fail(f"heal {label}: a param leaf {tuple(w.shape)} differs")
        n += w.numel() * 4
    for m in ("mu", "nu"):
        for g, w in zip(flatten(out["user"]["opt_state"][m])[0],
                        flatten(ref["user"]["opt_state"][m])[0]):
            want = w if wire is None else qk.plain["cast_bf16"](w).float()
            if not _bits_equal(g, want):
                fail(f"heal {label}: a {m} leaf {tuple(w.shape)} differs from "
                     f"the donor's{' through the bf16 cast' if wire else ''}")
            n += w.numel() * 4
    if out["user"]["opt_state"]["count"] != HEAL_STEP or \
            out["torchft"] != ref["torchft"]:
        fail(f"heal {label}: counters {out['torchft']}")
    return n


def phase_heal_transport(workdir: str, device: str = "cuda",
                         lm: dict = BIG_LM) -> dict:
    """A donor process publishes one group's state of ``lm`` (params and
    AdamW moments, f32 on ``device``); this process fetches it by every
    path and wire and holds each result against the donor's state."""
    from torchft_tpu_torch import checkpointing as ck

    dev = torch.device(device)
    log_path = os.path.join(workdir, "heal_donor.log")
    proc = _popen_worker(
        ["--heal-donor", json.dumps({"device": device, "lm": lm})], None,
        err_path=log_path)
    try:
        ref = _heal_state(lm, dev)
        address = _json_line(proc.stdout)["address"] + str(HEAL_STEP)
        fetches = []
        for label, path, wire, streams in HEAL_FETCHES:
            out, stats = _heal_fetch(ck, address, path, wire, streams, dev)
            if stats["path"] != path:
                fail(f"heal {label}: took the {stats['path']} path")
            checked = _check_healed(label, out, ref, wire)
            del out
            fetches.append({"fetch": label, **stats,
                            "bytes": stats.get("bytes", checked),
                            "state_bytes": checked})
            log(f"  heal {label}: fetch_s {stats['fetch_s']:.4f}, h2d_s "
                f"{stats['h2d_s']:.4f}, {fetches[-1]['bytes']} B on the wire, "
                f"{checked} B of state checked")
        proc.stdin.write("done\n")
        proc.stdin.flush()
        donor = _json_line(proc.stdout)
        proc.wait(timeout=60)
    except BaseException:
        with open(log_path) as f:
            log(f"  heal donor log: {f.read()[-3000:]}")
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        fail(f"the heal donor exited {proc.returncode}")
    return {"fetches": fetches, "launches": donor["launches"],
            "staging_build_s": donor["staging_build_s"],
            "crc_s": donor["crc_s"]}


def check_heal_transport(res: dict, on_card: bool = True,
                         lm: dict = BIG_LM) -> None:
    """K3 narrowed the moments on the bf16 wire: one launch per 64 of the
    donor's opt_state f32 leaves (both bf16 fetches read one staging)."""
    from torchft_tpu_torch.ops._lib import _kernels

    n_moments = 2 * len(_lm_shapes(lm))
    want = {k: 0 for k in res["launches"]}
    if on_card:
        cap = _kernels.lib().tft_seg_capacity()
        want["cast_bf16"] = -(-n_moments // cap)
    if res["launches"] != want:
        fail(f"heal transport launches {res['launches']} != {want}")


# -- remat on the flash LM ----------------------------------------------------

# (label, remat, remat_policy) of each forward+backward of the remat phase
REMAT_MODES = [("off", False, None), ("full", True, None),
               ("save_attn", True, "save_attn")]
# remat vs no remat when not bit-identical: two bf16 steps of each
# gradient leaf's absmax (the recompute would have to round differently)
REMAT_GRAD_RTOL = 2.0 ** -7


def phase_remat(device: str = "cuda", lm: dict = BIG_LM,
                batch: int = BIG_BATCH, seq: int = BIG_SEQ) -> dict:
    """One forward+backward of ``lm`` per remat mode on the same weights
    and tokens (after one untimed pass): its time, its peak memory over
    what the weights hold, its K4/K5 launches (reset to 0 just before it,
    read just after) and its gradients against remat off."""
    import dataclasses

    from torchft_tpu_torch._tree import flatten
    from torchft_tpu_torch.models import transformer as tt
    from torchft_tpu_torch.ops import quantize_kernels as qk

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    base = tt.TransformerConfig(**lm)
    params = tt.init_params(base, seed=0, device=dev)
    for p in flatten(params)[0]:
        p.requires_grad_(True)
    tokens = _tokens({"group": 0, "lm": lm, "batch": batch, "seq": seq},
                     10**6 + 2, dev)
    tt.make_grad_fn(base)(params, tokens)  # untimed: library init
    rows, ref = [], None
    for label, remat, policy in REMAT_MODES:
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        grad_fn = tt.make_grad_fn(cfg)
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.memory_allocated(dev)
        qk.reset_launch_counts()
        t0 = time.perf_counter()
        loss, grads = grad_fn(params, tokens)
        if on_card:
            torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        launches = dict(qk.launch_counts)
        leaves = flatten(grads)[0]
        row = {"mode": label, "ms": ms, "loss": float(loss),
               "launches": launches,
               "peak_gb": (torch.cuda.max_memory_allocated(dev) - start) / 2**30
               if on_card else None}
        if ref is None:
            ref = leaves
        else:
            same = all(_bits_equal(a, b) for a, b in zip(leaves, ref))
            row["bit_identical"] = same
            if not same:
                rel = max(_max_abs_err(a, b) / max(float(b.abs().max()), 1e-30)
                          for a, b in zip(leaves, ref))
                row["max_rel_err"] = rel
        rows.append(row)
        del grads, leaves
    return {"rows": rows, "n_layers": base.n_layers}


def check_remat(res: dict, on_card: bool = True) -> dict:
    """K4 n_layers / 2 n_layers / n_layers and K5 2 n_layers launches per
    pass (remat off / full / save_attn), finite losses, and gradients
    bit-identical to remat off (else within REMAT_GRAD_RTOL, printed)."""
    n = res["n_layers"]
    per_fwd = {"off": 1, "full": 2, "save_attn": 1}
    launches: dict = {}
    for row in res["rows"]:
        want = dict.fromkeys(row["launches"], 0)
        if on_card:
            want["flash_fwd"] = per_fwd[row["mode"]] * n
            want["flash_bwd"] = 2 * n
        if row["launches"] != want:
            fail(f"remat {row['mode']}: launches {row['launches']} != {want}")
        if not _finite(row["loss"]):
            fail(f"remat {row['mode']}: non-finite loss {row['loss']}")
        if row.get("bit_identical") is False:
            log(f"  remat {row['mode']}: gradients not bit-identical to remat "
                f"off; max |diff| / leaf absmax {row['max_rel_err']:.3e} "
                f"(tolerance {REMAT_GRAD_RTOL:.3e})")
            if not row["max_rel_err"] <= REMAT_GRAD_RTOL:
                fail(f"remat {row['mode']}: gradients off by "
                     f"{row['max_rel_err']:.3e} of a leaf's absmax")
        for k, v in row["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"launches": launches}


# -- the repository's experiments on the card ----------------------------------------

EXPERIMENTS = os.path.join(REPO, "experiments")
# the experiments phase: each row's warm-up and timed calls
EXP_WARM, EXP_ITERS = 1, 3
EXP_TIMEOUT_S = 600
# the rows the phase prints: mfu_breakdown_torch's, then flash_sweep_torch's
# at the flagship's in-model shape (the sweep's "dense" row is the plain
# version)
EXP_MFU_ROWS = ("step_full", "grad_only", "fwd_only", "step_no_attn",
                "step_mean_loss", "attn_standalone")
EXP_SWEEP_ROWS = ("dense", "ours bq=64 bk=64", "ours bq=64 bk=32",
                  "sdpa flash")
# --experiments-phases: the four experiments in full, each (script, the
# environment that picks its mode), then verify_e2e_torch.sh
EXP_FULL_RUNS = (
    ("mfu_breakdown_torch.py", {}),
    ("flash_sweep_torch.py", {"EXP_MODE": "attn"}),
    ("flash_sweep_torch.py", {"EXP_MODE": "model"}),
    *(("ablate_big_shape_torch.py", {"EXP_ABL": mode})
      for mode in ("layers", "fused", "loss", "blocks")),
    ("join_starvation_repro_torch.py", {}),
)
VERIFY_E2E = os.path.join(EXPERIMENTS, "verify_e2e_torch.sh")
EXP_FULL_TIMEOUT_S = 900


def experiments_worker(cfg: dict) -> None:
    """The experiments phase's process: every row of
    experiments/mfu_breakdown_torch.py, then flash_sweep_torch.py's attn
    rows at the flagship's in-model shape, ``warm`` warm-up and ``iters``
    timed calls a row (the matmul yardstick the script's 32: on an H100
    80GB HBM3 at 700 W, three calls of 1.4 ms timed together on the host
    clock read 625-636 TFLOP/s, 32 read 783). Each row's launch counts go to 0 just
    before it and are read just after (and checked there, per call);
    every K4/K5 call of a row, warm-up and timed, is held against its
    plain version between calls (``common_torch.PlainCheck``). Writes the
    result to ``cfg["out"]``."""
    import importlib

    sys.path.insert(0, EXPERIMENTS)
    mfu = importlib.import_module("mfu_breakdown_torch")
    sweep = importlib.import_module("flash_sweep_torch")
    dev = torch.device(cfg["device"])
    check = mfu.ct.PlainCheck()
    res = mfu.run(dev, cfg["size"], cfg["warm"], cfg["iters"], check=check,
                  log=log)
    label, shape = sweep.ATTN_SHAPES[cfg["size"]][-1]
    res["sweep"] = sweep.attn_rows(label, shape, dev, cfg["warm"],
                                   cfg["iters"], check, log=log)
    with open(cfg["out"], "w") as f:
        json.dump(res, f)


def phase_experiments(workdir: str, device: str = "cuda",
                      size: str = "flagship") -> dict:
    """The experiments worker, in one pooled (warm) process; its result
    and seconds."""
    out = os.path.join(workdir, "experiments.json")
    log_path = os.path.join(workdir, "experiments.log")
    cfg = {"role": "experiments", "device": device, "size": size,
           "warm": EXP_WARM, "iters": EXP_ITERS, "out": out}
    t0 = time.perf_counter()
    proc = _popen_worker(["--worker", json.dumps(cfg)], log_path)
    try:
        proc.wait(timeout=EXP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    with open(log_path) as f:
        text = f.read()
    if proc.returncode != 0:
        fail(f"the experiments worker exited {proc.returncode}:\n{text[-3000:]}")
    with open(out) as f:
        res = json.load(f)
    res["total_s"] = time.perf_counter() - t0
    return res


def check_experiments(res: dict, on_card: bool = True) -> dict:
    """Every row of both scripts, each with a finite positive time; on the
    card, as many K4/K5 calls held against their plain versions in each
    row as it launched, K4/K5 launched in the phase, and step_no_attn
    launching neither. Returns the phase's launches (the rows' sums) and
    the rows."""
    rows = res["rows"] + res["sweep"]
    mfu_names = [r["row"] for r in res["rows"]][1:]  # after the matmul row
    sweep_names = [r["row"].split(" ", 2)[2] for r in res["sweep"]]
    if mfu_names != list(EXP_MFU_ROWS) or sweep_names != list(EXP_SWEEP_ROWS):
        fail(f"experiments: rows {mfu_names} {sweep_names}")
    launches: dict = {}
    for r in rows:
        if not (_finite(r["ms"]) and r["ms"] > 0):
            fail(f"experiments {r['row']}: time {r['ms']}")
        for kernel, name, per in (("K4", "flash_fwd", 1), ("K5", "flash_bwd", 2)):
            n = r["launches"].get(name, 0)
            launches[name] = launches.get(name, 0) + n
            held = r["check"].get(kernel, {}).get("calls", 0)
            if on_card and held != n // per:
                fail(f"experiments {r['row']}: {held} {kernel} calls held "
                     f"against the plain version, the row made {n // per}")
    if on_card:
        if any(launches.get(k, 0) == 0 for k in ("flash_fwd", "flash_bwd")):
            fail(f"experiments: K4/K5 never launched ({launches})")
        no_attn = next(r for r in rows if r["row"] == "step_no_attn")
        if no_attn["launches"]:
            fail(f"experiments step_no_attn launched {no_attn['launches']}")
    return {"launches": launches, "rows": rows}


def experiments_phase(by_phase: dict) -> None:
    """The experiments phase: runs, is checked, logs each row on a line of
    its own, and puts its launch counts into ``by_phase``."""
    _phase("experiments")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_exp_") as workdir:
        try:
            res = phase_experiments(workdir)
            summ = check_experiments(res)
        finally:
            _keep_logs(workdir, "experiments")
    by_phase["experiments"] = summ["launches"]
    log(f"  experiments {res['total_s']:.1f} s in one pooled process "
        f"(experiments/mfu_breakdown_torch.py's rows, flash_sweep_torch.py's "
        f"at {tuple(res['sweep'][0]['shape'])}; {EXP_WARM} warm-up and "
        f"{EXP_ITERS} timed calls a row, the matmul 32; every K4/K5 call "
        f"held against its plain version between calls, off the clock); "
        f"launches {json.dumps(summ['launches'])}")
    for r in summ["rows"]:
        log("  experiments row " + json.dumps(_rounded(
            {k: r[k] for k in ("row", "ms", "launches", "path", "check")
             if k in r})))


def _rounded(obj, digits: int = 4):
    """``obj`` with every float to ``digits`` significant digits."""
    if isinstance(obj, float):
        return float(f"{obj:.{digits}g}")
    if isinstance(obj, dict):
        return {k: _rounded(v, digits) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_rounded(v, digits) for v in obj]
    return obj


def _run_experiment(script: str, argv: list, env: dict,
                    log_path: str, timeout_s: float = EXP_FULL_TIMEOUT_S) -> int:
    """One experiment as a user runs it (a Python one through the pool):
    prints its output and seconds; returns its exit code."""
    t0 = time.perf_counter()
    if script.endswith(".sh"):
        with open(log_path, "w") as out:
            proc = subprocess.Popen(["bash", script, *argv], cwd=REPO,
                                    env={**os.environ, **env}, stdout=out,
                                    stderr=subprocess.STDOUT)
    else:
        proc = _popen_worker(argv, log_path, script, env=env)
    try:
        proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    seconds = time.perf_counter() - t0
    with open(log_path) as f:
        text = f.read()
    log(f"  experiment {os.path.relpath(script, REPO)} {json.dumps(env)}: "
        f"rc {proc.returncode} in {seconds:.1f} s")
    for line in text.splitlines():
        log(f"    {line}")
    return proc.returncode


def experiments_phases(by_phase: dict) -> None:
    """``--experiments-phases``: the default run's experiments phase, then
    the four experiments in full, each alone on the card (a warm pooled
    process each), then experiments/verify_e2e_torch.sh on the card.
    Fails at the end if any of them exited non-zero."""
    experiments_phase(by_phase)
    _phase("experiments in full")
    failed = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_expfull_") as workdir:
        try:
            for i, (script, env) in enumerate(EXP_FULL_RUNS):
                if _run_experiment(os.path.join(EXPERIMENTS, script), [], env,
                                   os.path.join(workdir, f"run{i}.log")):
                    failed.append(f"{script} {env}")
            _phase("verify e2e")
            if _run_experiment(VERIFY_E2E, [],
                               {"WORKDIR": os.path.join(workdir, "verify_e2e")},
                               os.path.join(workdir, "verify_e2e.log")):
                failed.append("verify_e2e_torch.sh")
        finally:
            _keep_logs(workdir, "experiments_full")
    if failed:
        fail(f"experiments exited non-zero: {failed}")


# -- bench_torch.py: fault tolerance against a raw loop --------------------------

BENCH = os.path.join(REPO, "bench_torch.py")
# the default run's bench phase (bench_torch's own functions, fixed
# steps): the raw window's bound and steps at bench's dense model, the
# int8 ring session's held steps then its timed ones at ddp_small, the
# blocking and pipelined f32 sessions' steps at the dense model, the
# DiLoCo window's warm-up and inner steps; a session's window bound
# (its steps end it first)
BENCH_RAW_S, BENCH_RAW_STEPS = 3.0, 10
BENCH_HELD_STEPS, BENCH_DDP_SMALL_STEPS = 2, 4
BENCH_DDP_STEPS = 3
BENCH_DILOCO_WARM, BENCH_DILOCO_STEPS = 2, 4
BENCH_WINDOW_S = 20.0
# --bench-phases: bench_torch.py in full as a user runs it, with this
# attempt budget (its phases take ~700-800 s on the card), then the
# three experiments that import it
BENCH_FULL_TIMEOUT_S = 1000
BENCH_FULL_PHASES = ("raw", "transfer", "ft_diloco", "ft_ddp_small", "ft_ddp",
                     "big", "big2")
BENCH_EXPERIMENTS = ("ddp_phase_breakdown_torch.py", "ddp_modes_torch.py",
                     "ddp_small_tpu_breakdown_torch.py")


def _bench_peer_popen(argv: list, log_path: str, env: dict) -> subprocess.Popen:
    """bench_torch's ring peers through the pool (warm on the card)."""
    return _popen_worker(argv, log_path, BENCH, env=env)


class _Recorder:
    """Calls ``fn`` and, while ``armed``, keeps each call's arguments and
    output by reference: the caller holds them before the next step
    writes over its inputs."""

    def __init__(self, fn) -> None:
        self.fn = fn
        self.armed = False
        self.calls: list = []

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        if self.armed:
            self.calls.append((args, kw, out))
        return out


def _to_cpu(tree):
    from torchft_tpu_torch._tree import tree_map

    return tree_map(lambda t: t.detach().cpu() if torch.is_tensor(t) else t,
                    tree)


def _tree_bits_held(label: str, got, want) -> int:
    """Fails unless the trees match leaf for leaf, bit for bit; returns
    the number of leaves."""
    from torchft_tpu_torch._tree import flatten

    a, da = flatten(_to_cpu(got))
    b, db = flatten(want)
    if da != db or len(a) != len(b):
        fail(f"bench: {label}: tree structure differs from the plain version")
    for i, (x, y) in enumerate(zip(a, b)):
        if not _bits_equal(x, y):
            fail(f"bench: {label}: leaf {i} differs from the plain version")
    return len(a)


def _hold_quantize(calls: list) -> int:
    """Each recorded ``quantize_with_feedback`` call (the int8 payload of
    a step) against the plain path on CPU copies of its gradients and
    carry: codes, scales, decoded values and new carry, bit for bit."""
    from torchft_tpu_torch.quantize import quantize_with_feedback

    n = 0
    for (tree, residual), _, out in calls:
        plain = quantize_with_feedback(_to_cpu(tree), _to_cpu(residual))
        for k in ("q", "scale", "dq", "res"):
            n += _tree_bits_held(f"int8 payload {k}", out[k], plain[k])
    return n


def _hold_combine(calls: list) -> int:
    """Each recorded member-wise average (K2 per member) against the
    plain path on CPU copies of the gathered entries, bit for bit."""
    from torchft_tpu_torch.quantize import make_dequant_average

    plain = make_dequant_average()
    return sum(_tree_bits_held("int8 average", out,
                               plain(_to_cpu(entries), n))
               for (entries, n), _, out in calls)


def _hold_cast(calls: list) -> int:
    """Each recorded bf16 cast of a DiLoCo delta (K3) against the plain
    path on a CPU copy of the delta, bit for bit."""
    from torchft_tpu_torch.quantize import cast_bf16_tree

    return sum(_tree_bits_held("bf16 delta", out, cast_bf16_tree(_to_cpu(tree)))
               for (tree,), _, out in calls)


def _finite_params(state) -> bool:
    from torchft_tpu_torch._tree import flatten

    return all(bool(torch.isfinite(l).all()) for l in flatten(state.params)[0])


def phase_bench(device: str = "cuda", ddp_small_batch: "int | None" = None,
                popen=_bench_peer_popen) -> dict:
    """bench_torch.py's phases at fixed depth, in this process, each ring
    peer a pooled process on the host CPU: a raw window at bench's dense
    model; one int8 ``PipelinedDDP`` ring session at ``ddp_small`` (its
    first steps' payloads, member-wise averages and K4/K5 calls held
    against their plain versions, then timed steps); one blocking and one
    pipelined f32 session at the dense model; one ``_DilocoHarness``
    window on the bf16 wire (its warm syncs' K3 casts held). Launch
    counts go to 0 just before and are read just after."""
    import bench_torch as bench

    sys.path.insert(0, EXPERIMENTS)
    import common_torch as ct
    from torchft_tpu_torch import AdamW, FTTrainState, PipelinedDDP
    from torchft_tpu_torch import ddp as ddp_mod
    from torchft_tpu_torch import local_sgd
    from torchft_tpu_torch.models import transformer as tt
    from torchft_tpu_torch.ops import launch_counts, reset_launch_counts

    dev = torch.device(device)
    t0 = time.perf_counter()
    cfg, batch, _ = bench._model_setup("small", dev)
    tx = AdamW(1e-3)
    train_step = tt.make_train_step(cfg, tx)
    qrec = _Recorder(ddp_mod.quantize_with_feedback)
    krec = _Recorder(local_sgd.cast_bf16_tree)
    check = ct.PlainCheck()
    held: dict = {}
    out: dict = {"device": str(dev)}
    finite = []
    ddp_mod.quantize_with_feedback = qrec
    local_sgd.cast_bf16_tree = krec
    reset_launch_counts()
    try:
        # the peers read their model from BENCH_* (bench.py's contract)
        with mock.patch.dict(os.environ,
                             {"BENCH_FORCE_LAYERS": str(cfg.n_layers)}):
            raw = bench._time_raw_loop(
                train_step, lambda: tt.init_params(cfg, 0, dev), tx, batch, 2,
                BENCH_RAW_S, max_steps=BENCH_RAW_STEPS)
            out["raw"] = {"steps_per_sec": raw}
            small_env = {"BENCH_MODEL": "ddp_small"}
            if ddp_small_batch:
                small_env["BENCH_DDP_SMALL_BATCH"] = str(ddp_small_batch)
            with mock.patch.dict(os.environ, small_env):
                scfg, sbatch, _ = bench._model_setup("ddp_small", dev)
                state = FTTrainState(bench._grad_params(scfg, dev), tx)
                with bench._ring_session("smoke_ddp_small", "int8", state,
                                         device=dev, popen=popen) as (
                        manager, collectives):
                    ddp = PipelinedDDP(manager, state, tt.make_grad_fn(scfg),
                                       compress="int8", transport="legacy")
                    crec = ddp._combine = _Recorder(ddp._combine)
                    commits, parts = [], []

                    def step():
                        ddp.step(sbatch)
                        if ddp.last_commit is not None:
                            commits.append(ddp.last_commit)
                            ddp.last_commit = None
                        parts.append(manager.num_participants())

                    held["int8 payload leaves"] = held["int8 average leaves"] = 0
                    with check.active("bench ddp_small"):
                        for _ in range(BENCH_HELD_STEPS):
                            qrec.armed = crec.armed = True
                            step()
                            qrec.armed = crec.armed = False
                            check.flush()
                            held["int8 payload leaves"] += _hold_quantize(
                                qrec.calls)
                            held["int8 average leaves"] += _hold_combine(
                                crec.calls)
                            qrec.calls.clear()
                            crec.calls.clear()
                    t1 = time.perf_counter()
                    n, _ = bench._timed_window(
                        step, lambda: None, BENCH_WINDOW_S,
                        max_steps=BENCH_DDP_SMALL_STEPS, rate_hint=0.15)
                    commits.append(ddp.flush())
                    bench._barrier(state.params)
                    out["ddp_small"] = {
                        "steps_per_sec": n / (time.perf_counter() - t1),
                        "batch": list(sbatch.shape), "commits": commits,
                        "participants": parts,
                        "ring_size": collectives.size()}
                finite.append(_finite_params(state))
            held["K4/K5"] = check.summary("bench ddp_small")
            grad_fn = tt.make_grad_fn(cfg)
            for mode in ("blocking", "pipelined"):
                res = bench._ft_ddp_session(
                    mode, "f32", cfg, tx, grad_fn, batch, BENCH_WINDOW_S, dev,
                    popen, max_steps=BENCH_DDP_STEPS)
                finite.append(_finite_params(res.pop("state")))
                out[mode] = res
            harness = bench._DilocoHarness(
                FTTrainState(tt.init_params(cfg, 0, dev), tx), train_step,
                batch, "bf16", overlap=True, tag="smoke_diloco", device=dev,
                popen=popen)
            try:
                krec.armed = True
                sync_s = harness.warm(BENCH_DILOCO_WARM)
                krec.armed = False
                parts = [harness.manager.num_participants()]
                held["bf16 delta leaves"] = _hold_cast(krec.calls)
                krec.calls.clear()
                win = harness.window(BENCH_WINDOW_S,
                                     max_steps=BENCH_DILOCO_STEPS)
                out["diloco"] = {**win, "sync_s": sync_s,
                                 "commits": list(harness.commits),
                                 "participants": parts + [
                                     harness.manager.num_participants()],
                                 "ring_size": harness.collectives.size()}
                finite.append(_finite_params(harness.state))
            finally:
                harness.close()
        out["launches"] = {k: v for k, v in launch_counts.items() if v}
    finally:
        ddp_mod.quantize_with_feedback = qrec.fn
        local_sgd.cast_bf16_tree = krec.fn
    out["held"] = held
    out["finite"] = finite
    out["total_s"] = time.perf_counter() - t0
    return out


def check_bench(res: dict, on_card: bool = True) -> dict:
    """Every session on a ring of 2 with at least 2 participants at some
    step, every FT step committed, params finite, each wire path held
    against its plain version at least once (the int8 payloads and
    averages, the bf16 deltas: bit for bit), and on the card K4/K5 held
    (``PlainCheck``) and all six kernels launched. Returns the phase's
    launches."""
    for name in ("ddp_small", "blocking", "pipelined", "diloco"):
        r = res[name]
        if r["ring_size"] != 2 or max(r["participants"], default=0) < 2:
            fail(f"bench {name}: ring {r['ring_size']}, participants "
                 f"{r['participants']}")
        if not r["commits"] or not all(r["commits"]):
            fail(f"bench {name}: commits {r['commits']}")
    if not all(res["finite"]):
        fail(f"bench: non-finite params {res['finite']}")
    held = res["held"]
    for k in ("int8 payload leaves", "int8 average leaves", "bf16 delta leaves"):
        if held.get(k, 0) < 1:
            fail(f"bench: no {k} held against the plain version")
    if on_card:
        for kernel in ("K4", "K5"):
            if held["K4/K5"].get(kernel, {}).get("calls", 0) < 1:
                fail(f"bench: {kernel} never held against its plain version")
        missing = [k for k in ("q8_absmax", "q8_quantize", "q8_dequantize",
                               "cast_bf16", "flash_fwd", "flash_bwd")
                   if res["launches"].get(k, 0) == 0]
        if missing:
            fail(f"bench: {missing} never launched")
    return {"launches": res["launches"]}


def bench_phase(by_phase: dict) -> None:
    """The bench phase: runs, is checked, logs each sub-result on a line
    of its own, and puts its launch counts into ``by_phase``."""
    _phase("bench")
    res = phase_bench()
    summ = check_bench(res)
    by_phase["bench"] = summ["launches"]
    log(f"  bench {res['total_s']:.1f} s in this process (bench_torch.py's "
        f"functions at fixed depth, each ring peer a pooled process on the "
        f"host CPU); launches {json.dumps(summ['launches'])}")
    for name in ("raw", "ddp_small", "blocking", "pipelined", "diloco"):
        log(f"  bench {name} " + json.dumps(_rounded(res[name])))
    log("  bench held " + json.dumps(_rounded(res["held"])))


def _bench_full_check(detail: dict) -> list:
    """What keeps a full bench_torch.py run from counting: a phase
    missing, errored or skipped (for time or otherwise), or a window it
    did not measure."""
    bad = []
    for name in BENCH_FULL_PHASES:
        r = detail.get(name)
        if not isinstance(r, dict):
            bad.append(f"{name}: missing")
        elif "error" in r or "skipped" in r:
            bad.append(f"{name}: {r.get('error') or r.get('skipped')}")
    if "skipped_window_1" in (detail.get("ft_diloco") or {}):
        bad.append("ft_diloco: window 1 skipped")
    if (detail.get("big") or {}).get("windows_measured") not in (None, 2):
        bad.append("big: a window skipped")
    return bad


def bench_phases(by_phase: dict) -> None:
    """``--bench-phases``: the default run's bench phase, then, with the
    warm pool closed, ``bench_torch.py`` in full as a user runs it
    (BENCH_ATTEMPT_TIMEOUT_S BENCH_FULL_TIMEOUT_S), then the three
    experiments that import it, each alone on the card. Fails at the end
    if any exited non-zero, or bench_torch.py left a phase errored,
    skipped or unmeasured."""
    bench_phase(by_phase)
    # bench_torch.py and the experiments run alone on the card, as a user
    # runs them, cold: its dense probe of the flash cell's LM takes
    # nearly all of the card's memory, which the pool's spares share
    global POOL
    if POOL is not None:
        POOL.close()
        POOL = None
    torch.cuda.empty_cache()
    _phase("bench in full")
    failed = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_benchfull_") as workdir:
        try:
            out = os.path.join(workdir, "bench.json")
            log_path = os.path.join(workdir, "bench.log")
            rc = _run_experiment(
                BENCH, ["--out", out],
                {"BENCH_ATTEMPT_TIMEOUT_S": str(BENCH_FULL_TIMEOUT_S)},
                log_path, timeout_s=BENCH_FULL_TIMEOUT_S + 120)
            with open(log_path) as f:
                if not any(l.startswith('{"metric": "steps_per_sec_ft"')
                           for l in f):
                    failed.append("bench_torch.py printed no metric line")
            if rc:
                failed.append(f"bench_torch.py exited {rc}")
            if os.path.exists(out):
                with open(out) as f:
                    detail = json.load(f)
                for name in ("host", *BENCH_FULL_PHASES):
                    if name in detail:
                        log(f"  bench_torch {name} "
                            + json.dumps(detail[name]))
                failed += [f"bench_torch.py {b}" for b in
                           _bench_full_check(detail)]
            else:
                failed.append("bench_torch.py wrote no --out JSON")
            _phase("bench experiments")
            for i, script in enumerate(BENCH_EXPERIMENTS):
                if _run_experiment(os.path.join(EXPERIMENTS, script), [], {},
                                   os.path.join(workdir, f"exp{i}.log")):
                    failed.append(script)
        finally:
            _keep_logs(workdir, "bench_full")
    if failed:
        fail(f"bench phases failed: {failed}")


# -- bench_churn_torch.py: throughput under kills, the durable tier -------------

CHURN = os.path.join(REPO, "bench_churn_torch.py")
CHURN_LOGS = os.path.join(REPO, ".bench_churn_torch_logs")
CHURN_PHASES = ("healthy", "churn", "churn_hot")
# the default run's churn phase: --dryrun (three phases of 48 steps, each
# under a 300 s deadline) on the bf16 heal wire, where group 0 (on the
# card) is the only donor and narrows its moments with K3 for each heal
# it serves; then run_durable_phase in this process at the dryrun's size
CHURN_ENV = {"TORCHFT_HEAL_WIRE": "bf16"}
CHURN_DRYRUN_TIMEOUT_S = 600
CHURN_DURABLE_ELEMS, CHURN_DURABLE_CHECKPOINTS = 1_000_000, 2
# --churn-phases: the tool in full on the card, as a user runs it
CHURN_FULL_ARGS = ["--groups", "4", "--steps", "1200", "--kill-every", "100",
                   "--hot-spare"]
CHURN_FULL_TIMEOUT_S = 1500
DURABLE_FULL_TIMEOUT_S = 300


def durable_k3_launches(n_elems: int, checkpoints: int,
                        world_old: int) -> int:
    """K3's launches in ``run_durable_phase``: one a snapshot for each
    member whose shard holds bytes of the narrowed moments.

    A snapshot stages ``{"user": {"opt_state": {"m", "v"}, "params":
    {"w"}}, "torchft": <ints>}``, its leaves in sorted-key order: the
    moments first, narrowed to bf16 (``2 * n`` bytes each), then ``w``
    raw (``4 * n``), so the stream is ``8 * n`` bytes with the moments in
    ``[0, 4 * n)``. A member of rank r stages only ``[8n r // W,
    8n (r + 1) // W)`` (``durable.shard_bounds``) and narrows what of the
    moments falls there with one K3 launch
    (``checkpointing._StreamStaging._copy_in``: one ``cast_bf16_group``
    over at most 64 leaves), none when nothing does. The sync baseline's
    one member (W = 1) narrows both moments at every snapshot; of the
    async members at W = 3 ranks 0 and 1 meet the moments and rank 2
    holds only ``w``: 3 launches a checkpoint."""
    total, moments = 8 * n_elems, 4 * n_elems
    async_members = sum(
        1 for r in range(world_old)
        if total * r // world_old < min(moments, total * (r + 1) // world_old))
    return checkpoints * (1 + async_members)


def _run_churn_tool(argv: list, env: dict, log_path: str,
                    timeout_s: float) -> tuple:
    """``bench_churn_torch.py *argv`` as a user runs it (through the pool
    when there is one): ``(rc, seconds, its metric line or None)``; prints
    its exit, seconds and metric line, and on a failure its log's tail."""
    t0 = time.perf_counter()
    proc = _popen_worker(argv, log_path, CHURN, env=env)
    try:
        proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    seconds = time.perf_counter() - t0
    with open(log_path) as f:
        text = f.read()
    metric = None
    for line in text.splitlines():
        if line.startswith('{"metric"'):
            metric = json.loads(line)
    log(f"  bench_churn_torch.py {' '.join(argv)} {json.dumps(env)}: rc "
        f"{proc.returncode} in {seconds:.1f} s; {json.dumps(metric)}")
    if proc.returncode:
        log("    " + text[-3000:].replace("\n", "\n    "))
    return proc.returncode, seconds, metric


def _keep_churn_logs(workdir: str, name: str) -> None:
    """:func:`_keep_logs` of ``workdir`` with the tool's own logs in it."""
    if os.path.isdir(CHURN_LOGS):
        import shutil

        shutil.copytree(CHURN_LOGS, os.path.join(workdir, "logs"),
                        dirs_exist_ok=True)
    _keep_logs(workdir, name)


def _churn_logs() -> dict:
    """The dryrun's records by phase and group, and group 0's kernel
    launches by phase (the launch counts its worker wrote at its end)."""
    import bench_churn_torch as bct

    out: dict = {"records": {}, "launches": {}}
    for phase in CHURN_PHASES:
        for g in range(2):
            out["records"][(phase, g)] = bct._read_log(
                os.path.join(CHURN_LOGS, f"{phase}_g{g}.jsonl"))
        path = os.path.join(CHURN_LOGS, f"{phase}_g0.jsonl.launches.json")
        if os.path.exists(path):
            with open(path) as f:
                out["launches"][phase] = json.load(f)
    return out


def phase_churn(device: str = "cuda",
                durable_elems: int = CHURN_DURABLE_ELEMS,
                durable_checkpoints: int = CHURN_DURABLE_CHECKPOINTS) -> dict:
    """``bench_churn_torch.py --dryrun`` as a user runs it, group 0 on the
    card and the bf16 heal wire; ``run_durable_phase`` in this process at
    the dryrun's size (launch counts 0 just before, read just after), its
    restored state kept; then ``--durable --dryrun`` as a user runs it.
    On the CPU (a rehearsal) both runs take ``--device cpu``."""
    import bench_churn_torch as bct
    from torchft_tpu_torch.ops import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    dev_args = ["--device", "cpu"] if device == "cpu" else []
    out: dict = {"device": device}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_churn_") as workdir:
        try:
            rc, secs, metric = _run_churn_tool(
                ["--dryrun", *dev_args], CHURN_ENV,
                os.path.join(workdir, "dryrun.log"), CHURN_DRYRUN_TIMEOUT_S)
            out["dryrun"] = {"rc": rc, "s": secs, "metric": metric,
                             **_churn_logs()}
            reset_launch_counts()
            states: dict = {}
            t1 = time.perf_counter()
            record = bct.run_durable_phase(
                n_elems=durable_elems, checkpoints=durable_checkpoints,
                device=device, states=states)
            out["durable"] = {
                "record": record, "states": states,
                "launches": {k: v for k, v in launch_counts.items() if v},
                "s": time.perf_counter() - t1}
            rc, secs, metric = _run_churn_tool(
                ["--durable", "--dryrun", *dev_args], {},
                os.path.join(workdir, "durable_dryrun.log"),
                CHURN_DRYRUN_TIMEOUT_S)
            out["durable_dryrun"] = {"rc": rc, "s": secs, "metric": metric}
        finally:
            _keep_churn_logs(workdir, "churn")
    out["total_s"] = time.perf_counter() - t0
    return out


def _heal_rows(records: list) -> list:
    """A group log's heal records, each with ``restart``: whether a
    restarted incarnation logged it (after the log's second boot record
    or later; the first incarnation's heal is the step-0 weight sync)."""
    rows, boots = [], 0
    for r in records:
        boots += "boot" in r
        if "heal" in r:
            rows.append({**r["heal"], "restart": boots > 1})
    return rows


def check_churn(res: dict, on_card: bool = True) -> dict:
    """The dryrun exited 0 with ``churn_dryrun_ok`` 1; the churn and the
    hot-spare phase each logged a heal on the stream path and the bf16
    wire; on the card the hot-spare phase one by a promoted spare, and
    group 0 launched K3 (it served those heals) and nothing else. The in-process durable run: every member restored the
    last committed step bit-identical, its ``w`` bit for bit the saved
    one and its moments bit for bit K3's plain version of the saved ones,
    and on the card K3 launched exactly :func:`durable_k3_launches` times
    and nothing else did. ``--durable --dryrun`` exited 0 with
    ``durable_dryrun_ok`` 1. Returns the launches and the figures the
    phase prints."""
    from torchft_tpu_torch.ops import quantize_kernels as qk

    dry = res["dryrun"]
    if dry["rc"] != 0 or (dry["metric"] or {}).get("metric") != \
            "churn_dryrun_ok" or dry["metric"].get("value") != 1:
        fail(f"churn: --dryrun exited {dry['rc']} with {dry['metric']}")
    heals = {}
    for phase in ("churn", "churn_hot"):
        rows = [h for g in range(2)
                for h in _heal_rows(dry["records"][(phase, g)])]
        good = [h for h in rows
                if h.get("path") == "stream" and h.get("wire") == "bf16"]
        if not good:
            fail(f"churn: no stream heal on the bf16 wire in the {phase} "
                 f"phase: {rows}")
        heals[phase] = {"heals": len(rows), "stream_bf16": len(good),
                        "after_restart": sum(h["restart"] for h in good),
                        "fetch_s": _median([h["fetch_s"] for h in good])}
    # on the card a promoted spare joins within a few of group 0's steps,
    # so the hot-spare phase heals after its kills; a cold restart may
    # not (group 0's solo steps outrun it to the next kill, 10 steps on),
    # so the cold phase's count is printed, not required. A CPU rehearsal
    # under load may see neither.
    if on_card and not heals["churn_hot"]["after_restart"]:
        fail("churn: no promoted spare healed on the stream path and the "
             f"bf16 wire: {heals}")
    launches = {}
    if on_card:
        for phase in CHURN_PHASES:
            if phase not in dry["launches"]:
                fail(f"churn: group 0 wrote no launch counts in {phase}")
        for name in {k for c in dry["launches"].values() for k in c}:
            launches[name] = sum(c.get(name, 0)
                                 for c in dry["launches"].values())
        launches = {k: v for k, v in launches.items() if v}
        if set(launches) != {"cast_bf16"}:
            fail(f"churn: group 0 launched {launches}; K3 alone expected")

    dur = res["durable"]
    rec = dur["record"]
    restore = rec["durable_restore"]
    n, ckpts = rec["config"]["n_elems"], rec["config"]["checkpoints"]
    if restore["restored_step"] != ckpts or not restore[
            "members_bit_identical"] or not rec["shard_scaling_ok"]:
        fail(f"churn durable: restore {json.dumps(_rounded(restore))}, "
             f"scaling {rec['shard_scaling_ok']}")
    saved = dur["states"]["saved"]
    for i, st in enumerate(dur["states"]["restored"]):
        if not _bits_equal(st["params"]["w"].cpu(), saved["params"]["w"]):
            fail(f"churn durable: member {i}'s restored w differs from the "
                 "saved one")
        for k in ("m", "v"):
            want = qk._cast_bf16_plain(saved["opt_state"][k]).float()
            if not _bits_equal(st["opt_state"][k].cpu(), want):
                fail(f"churn durable: member {i}'s restored {k} is not K3's "
                     "plain version of the saved one")
    durable_launches = dur["launches"]
    want_k3 = durable_k3_launches(n, ckpts, rec["config"]["world_old"])
    if on_card and durable_launches != {"cast_bf16": want_k3}:
        fail(f"churn durable: launches {durable_launches}, expected "
             f"{{'cast_bf16': {want_k3}}}")
    dd = res["durable_dryrun"]
    if dd["rc"] != 0 or (dd["metric"] or {}).get("metric") != \
            "durable_dryrun_ok" or dd["metric"].get("value") != 1:
        fail(f"churn: --durable --dryrun exited {dd['rc']} with "
             f"{dd['metric']}")
    return {"launches": launches, "durable_launches": durable_launches,
            "durable_k3_expected": want_k3, "heals": heals,
            "stall_ratio_vs_sync": rec["stall_ratio_vs_sync"],
            "restore": {k: restore[k] for k in (
                "manifest_read_s", "shard_fetch_s", "reshard_s", "h2d_s",
                "compile_s", "wall_s")}}


def churn_phase(by_phase: dict) -> None:
    """The churn phase: runs, is checked, logs its figures, and puts
    group 0's launches (``churn``) and the in-process durable run's
    (``churn durable``) into ``by_phase``."""
    _phase("churn")
    res = phase_churn()
    summ = check_churn(res)
    by_phase["churn"] = summ["launches"]
    by_phase["churn durable"] = summ["durable_launches"]
    dry = res["dryrun"]
    log(f"  churn {res['total_s']:.1f} s: --dryrun {dry['s']:.1f} s "
        f"(group 0 on the card, bf16 heal wire) {json.dumps(dry['metric'])}; "
        f"heals {json.dumps(_rounded(summ['heals']))}; group 0's launches "
        f"{json.dumps(summ['launches'])}")
    log(f"  churn durable in process {res['durable']['s']:.1f} s at "
        f"{CHURN_DURABLE_ELEMS} elements x {CHURN_DURABLE_CHECKPOINTS} "
        f"checkpoints: K3 {summ['durable_launches'].get('cast_bf16', 0)} "
        f"launches (expected {summ['durable_k3_expected']}), stall ratio "
        f"{summ['stall_ratio_vs_sync']}, restore "
        f"{json.dumps(_rounded(summ['restore']))}; --durable --dryrun "
        f"{res['durable_dryrun']['s']:.1f} s "
        f"{json.dumps(res['durable_dryrun']['metric'])}")


def _headline(record: dict) -> dict:
    """A bench_churn_torch.py result without its per-row detail (the
    durable snapshots' rows, the restore's per-member stats)."""
    out = dict(record)
    if "async_sharded" in out:
        out["async_sharded"] = {k: v for k, v in out["async_sharded"].items()
                                if k != "rows"}
        out["durable_restore"] = {
            k: v for k, v in out["durable_restore"].items()
            if k != "per_member"}
    out.pop("note", None)
    return out


def churn_phases(by_phase: dict) -> None:
    """``--churn-phases``: the default run's churn phase, then, with the
    warm pool closed, ``bench_churn_torch.py`` in full on the card as a
    user runs it (``CHURN_FULL_ARGS``), then ``--durable``; prints each
    result's headline keys. Fails at the end if either exited non-zero or
    measured with ``measurement_ok`` false."""
    churn_phase(by_phase)
    global POOL
    if POOL is not None:
        POOL.close()
        POOL = None
    torch.cuda.empty_cache()
    failed = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_churnfull_") as workdir:
        try:
            for name, argv, timeout_s in (
                    ("churn in full", CHURN_FULL_ARGS, CHURN_FULL_TIMEOUT_S),
                    ("durable in full", ["--durable"],
                     DURABLE_FULL_TIMEOUT_S)):
                _phase(name)
                tag = name.split()[0]
                out = os.path.join(workdir, f"{tag}.json")
                rc, _, _ = _run_churn_tool(
                    [*argv, "--out", out], {},
                    os.path.join(workdir, f"{tag}.log"), timeout_s)
                if rc:
                    failed.append(f"{name}: exit {rc}")
                if not os.path.exists(out):
                    failed.append(f"{name}: no --out JSON")
                    continue
                with open(out) as f:
                    record = json.load(f)
                log(f"  {name} " + json.dumps(_headline(record)))
                if not record.get("measurement_ok"):
                    failed.append(f"{name}: measurement_ok false")
        finally:
            _keep_churn_logs(workdir, "churn_full")
    if failed:
        fail(f"churn phases failed: {failed}")


def _finite(v: float) -> bool:
    return v == v and abs(v) != float("inf")


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def _log_ring_split(cell: str, summary: dict) -> None:
    log(f"  ring split of the {cell} cell (group 0, median over the timed "
        f"steps; native per-bucket pack/ring/unpack summed over a step's "
        f"buckets and their largest, per-stripe ring, the port's "
        f"pack/d2h/ring split): {json.dumps(summary['ring_split'])}; "
        f"wire_eff_MBps {summary['signals']['wire_eff_MBps']}")


def flash_turns() -> int:
    """The flat q8 flash phase and the hier flash phase in turns (flat,
    hier, hier, flat) in one run, one JSON line per turn: step p50, the
    plan_allreduce dispatch -> result mean, the ring split (on the hier
    turns the d2h of the f32 leaves into the plan's pinned inputs) and
    the card's busy share over the traced steps."""
    log(f"  built: {json.dumps({k: round(v, 2) for k, v in phase_build().items()})}")
    for turn, kind in enumerate(("flat", "hier", "hier", "flat")):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_turn_") as workdir:
            res = phase_flash_train(workdir, hier=kind == "hier")
            fsum = check_flash_training(res, hier=kind == "hier")
        trace = fsum["trace"] or {}
        print(json.dumps({
            "turn": turn, "kind": kind, "step_ms_p50": fsum["step_ms_p50"],
            "step_ms_all": fsum["step_ms_all"],
            "window_ms_per_step": fsum["window_ms_per_step"],
            "plan_allreduce_ms": fsum["plan_allreduce_ms"],
            "ring_split": fsum["ring_split"],
            "ring_windows_ms": trace.get("ring_windows_ms"),
            "card_busy_share": trace.get("card_busy_share"),
            "loop_kernel_ms_total": trace.get("loop_kernel_ms_total"),
            "signals": fsum["signals"],
            "marks": [r.get("marks") for r in res["results"]],
            "total_s": res["total_s"]}), flush=True)
    print(_smi(), flush=True)
    return 0


# a fresh process's start, timed from inside it (``start_probe``)
_START_PROBE = r"""
import json, sys, time
t0 = time.perf_counter()
import torch
t = {"import_torch": time.perf_counter() - t0}
a = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t["cuda_context"] = time.perf_counter() - a
a = time.perf_counter()
sys.path.insert(0, sys.argv[2])
import torchft_tpu_torch
from torchft_tpu_torch.models import transformer as tt
t["import_port"] = time.perf_counter() - a
lms = json.loads(sys.argv[3])


def first_pass(name, batch, seq):
    cfg = tt.TransformerConfig(**lms[name])
    params = tt.TransformerLM(cfg, seed=0, device="cuda").params()
    tokens = torch.zeros((batch, seq + 1), dtype=torch.long, device="cuda")
    for i in (1, 2):
        a = time.perf_counter()
        tt.make_grad_fn(cfg)(params, tokens)
        torch.cuda.synchronize()
        t[f"{name}_pass{i}"] = time.perf_counter() - a


if sys.argv[1] == "warm_first":
    first_pass("warm", 2, 64)
first_pass(sys.argv[1] == "dense" and "dense" or "flash",
           16, 511 if sys.argv[1] == "dense" else 2047)
print(json.dumps({k: round(v, 3) for k, v in t.items()}))
"""


def start_probe() -> int:
    """A fresh process's start on the card, from inside it: ``import
    torch``, the CUDA context, the port's import, and the flash LM's
    first and second forward/backward, cold or after a one-block flash
    LM's (the pool's warm-up), and the dense LM's; twice each. The
    kernels are built first, so no process here builds them."""
    log(f"  built: {json.dumps({k: round(v, 2) for k, v in phase_build().items()})}")
    lms = json.dumps({"flash": BIG_LM, "dense": LM, "warm": POOL_WARM_LM})
    for mode in ("cold", "warm_first", "cold", "warm_first", "dense",
                 "dense"):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", _START_PROBE, mode, REPO,
                              lms], capture_output=True, text=True)
        if out.returncode != 0:
            fail(f"start probe {mode}: {out.stderr[-2000:]}")
        log(json.dumps({"mode": mode, "process_s": round(
            time.perf_counter() - t0, 3), **json.loads(out.stdout)}))
    print(_smi(), flush=True)
    return 0


def shm_probe() -> int:
    """Whether this machine's /dev/shm takes the host tier: two port
    members in one process, one host label, 4 stripes; three
    plan_allreduce(hier=True, wire="q8ef") steps on card leaves of 1 Ki
    and 16 Mi f32 elements, each checked against the exact average, with
    their d2h / native-call / shm split; then every segment unlinked."""
    from concurrent.futures import ThreadPoolExecutor
    from datetime import timedelta

    from torchft_tpu_torch import _native, collectives as tcol

    store = _native.Store()
    cols = [tcol.HostCollectives(timeout=timedelta(seconds=30), stripes=4)
            for _ in range(2)]
    try:
        addr = f"{store.address()}/probe"
        with ThreadPoolExecutor(2) as ex:
            for f in [ex.submit(c.configure, addr, r, 2, None, ["h", "h"])
                      for r, c in enumerate(cols)]:
                f.result()
        log(f"  hier {[c.hier_capable() for c in cols]}, host tier "
            f"{[c.host_tier_transport() for c in cols]}, live segments "
            f"{_native._lib.tft_shm_live_count()}")
        dev = torch.device("cuda")
        for n in (1 << 10, 1 << 24):
            for it in range(3):
                res = [None, None]

                def run(r):
                    x = {"a": torch.full((n,), float(r + 1), device=dev),
                         "b": torch.ones(7, device=dev)}
                    res[r] = cols[r].plan_allreduce(
                        x, tcol.ReduceOp.AVG, wire="q8ef", hier=True).wait()
                    torch.cuda.synchronize()

                threads = [threading.Thread(target=run, args=(r,))
                           for r in range(2)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
                if any(t.is_alive() for t in threads):
                    fail("shm probe: a member did not finish its step")
                if not all(torch.equal(x["a"], torch.full((n,), 1.5, device=dev))
                           for x in res):
                    fail(f"shm probe: wrong average at {n} elements")
                st = cols[0].pop_op_stats()[-1]
                log(f"  {n} elements, step {it}: " + json.dumps(
                    {k: st[k] for k in ("d2h", "ring", "shm_rs_s", "shm_ag_s",
                                        "shm_bcast_s", "py_staging_allocs")}))
    finally:
        for c in cols:
            c.shutdown()
        store.shutdown()
    live = _native._lib.tft_shm_live_count()
    log(f"  live segments after release: {live}")
    if live:
        fail(f"shm probe: {live} segments outlived release")
    print(_smi(), flush=True)
    return 0


def window_phases(by_phase: dict) -> None:
    """The window strategies' phases and AdaptiveDDP's: each runs, is
    checked and logged, and puts its launch counts into ``by_phase``."""
    _phase("async diloco flash + sharded diloco")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_diloco_") as workdir:
        dlres = phase_diloco_flash(workdir)
        adsum = check_async_diloco(dlres)
        sdsum = check_sharded_diloco(dlres)
    by_phase["async diloco flash"] = adsum["launches"]
    by_phase["sharded diloco"] = sdsum["launches"]
    log(f"  diloco flash {dlres['total_s']:.1f} s (two groups, inner steps "
        f"make_train_step(AdamW, bf16_params=True), outer SGD(0.7, "
        f"momentum=0.9, nesterov=True), sync quorum); raw inner step p50 "
        f"{adsum['raw_step_ms_p50']} ms (all: {adsum['raw_step_ms_all']}); "
        f"max_memory_allocated {adsum['max_memory_allocated_gb']} GiB")
    for mode, row in adsum["modes"].items():
        log(f"  async diloco {mode}: {json.dumps(row)}")
    log(f"  sharded diloco (q8 shard wire, bf16 param wire, "
        f"{SHARDED_DILOCO_WINDOWS} windows of {DILOCO_SYNC_EVERY}): inner "
        f"step p50 {sdsum['inner_step_ms_p50']} ms; sync ms "
        f"{sdsum['sync_ms']}; outer momentum {sdsum['outer_bytes']} B per "
        f"group; op split (group 0) {json.dumps(sdsum['ops'])}; launches "
        f"{json.dumps(sdsum['launches'])}")
    _phase("diloco reshard")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dreshard_") as workdir:
        drres = phase_diloco_reshard(workdir)
        drsum = check_diloco_reshard(drres)
    by_phase["diloco reshard"] = drsum["launches"]
    log(f"  diloco reshard {drres['total_s']:.1f} s: syncs per group "
        f"{drsum['commits']}, worlds {drsum['worlds']}; the joiner healed in "
        f"its start_quorum {json.dumps(drsum['fetch'])}; three groups "
        f"bit-identical, outer shards tile the model")
    _phase("adaptive flash")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_adaptive_") as workdir:
        apres = phase_adaptive_flash(workdir)
        apsum = check_adaptive(apres)
    by_phase["adaptive flash"] = apsum["launches"]
    log(f"  adaptive flash {apres['total_s']:.1f} s: locked "
        f"{apsum['mode']}; decision {json.dumps(apsum['decision'])}; mode per "
        f"step {apsum['modes']}; step ms per group {apsum['step_ms']}; "
        f"topology {json.dumps(apsum['topology'])}")


# -- durable tier, serving plane, parameter server -------------------------------

# durable flash: committed steps with the durable hook armed, and its
# cadence and retention (captures at steps 2 and 4, both kept)
DURABLE_STEPS, DURABLE_EVERY, DURABLE_KEEP = 4, 2, 2
# the AdamW moments of the flash LM (mu and nu per leaf): the f32 leaves
# K3 narrows on the durable bf16 wire
DURABLE_MOMENTS = 2 * 51
# the disk two flash-LM sets at keep=2 take (params f32 + bf16 moments),
# with room for the sync baseline's set
DURABLE_DISK_BYTES = 3 * (4 + 2 * 2) * 111_166_464
# serving flash: versions per wire (3 took 52.7 s of the default run
# with the parameter server's 3.3), the snapshot cadence, the wires. Two
# versions are a snapshot and one delta: a delta installed over an
# earlier delta, and the q8 publisher's carry into a second delta, run on
# the card in tests/test_torch_cuda_kernels.py::
# test_card_resident_served_tree_matches_the_cpu_publisher (6 versions)
SERVE_VERSIONS, SERVE_SNAPSHOT_EVERY = 2, 4
SERVE_WIRES = ("q8", "bf16", "f32")


def _k3_digest(opt_state) -> str:
    """sha256 of the plain K3 cast of every f32 moment (the bf16 words the
    durable wire must restore; a restored moment, exact bf16 values
    widened, casts back to the same words). The plain version: no
    launch is counted."""
    from torchft_tpu_torch._tree import flatten
    from torchft_tpu_torch.ops import quantize_kernels as qk

    h = hashlib.sha256()
    for m in ("mu", "nu"):
        for leaf in flatten(opt_state[m])[0]:
            h.update(qk.plain["cast_bf16"](leaf).view(torch.int16)
                     .cpu().numpy().tobytes())
    return h.hexdigest()


def durable_worker(cfg: dict) -> None:
    """One group of the durable flash phase: PipelinedDDP(q8) blocking
    steps on the big LM with a DurableCheckpointer(mode="async",
    wire="bf16", every 2, keep 2, register_hook=True) into the shared
    LocalDirStore, a hook after it recording the digests of what each
    capture saw, then one sync-mode capture (the stall baseline) into
    another store."""
    import torchft_tpu_torch as tft
    from torchft_tpu_torch.models import transformer as tt
    from torchft_tpu_torch.ops import quantize_kernels as qk

    g, workdir = cfg["group"], cfg["workdir"]
    device = torch.device(cfg["device"])
    on_card = device.type == "cuda"
    model_cfg = tt.TransformerConfig(**cfg["lm"])
    model = tt.TransformerLM(model_cfg, seed=0, device=device)
    state = tft.FTTrainState(model.params(), tft.AdamW(1e-3, weight_decay=1e-4))
    collectives = tft.HostCollectives()
    manager = tft.Manager(
        collectives=collectives, load_state_dict=state.load_state_dict,
        state_dict=state.state_dict, min_replica_size=2, rank=0,
        world_size=1, lighthouse_addr=cfg["lighthouse"], replica_id=f"g{g}",
        device=device,
    )
    ckpt = tft.DurableCheckpointer(
        cfg["store"], manager, state, every=DURABLE_EVERY, keep=DURABLE_KEEP,
        wire="bf16", mode="async", register_hook=True, device=device,
        commit_timeout_s=300.0, store=tft.LocalDirStore(cfg["store"]))
    saved: dict = {}

    def record(step: int, quorum_id: int, committed: bool) -> None:
        # runs after the checkpointer's hook, on the state it captured
        if committed and step % DURABLE_EVERY == 0:
            saved[step] = {"params": _digest(state.params),
                           "moments_k3": _k3_digest(state.opt_state)}

    manager.add_commit_hook(record)
    ddp = tft.PipelinedDDP(manager, state, tt.make_grad_fn(model_cfg),
                           compress="q8", transport="plan", device_pack=True)
    out: dict = {"group": g, "n_layers": len(state.params["blocks"])}
    try:
        qk.reset_launch_counts()
        commits, step_s, losses = [], [], []
        for i in range(DURABLE_STEPS):
            t0 = time.perf_counter()
            losses.append(float(ddp.blocking_step(_tokens(cfg, i, device))))
            if on_card:
                torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            commits.append(ddp.last_commit)
        out["launches"] = dict(qk.launch_counts)
        t0 = time.perf_counter()
        out["flushed"] = ckpt.flush(300)
        out["flush_s"] = time.perf_counter() - t0
        out["committed_steps"] = ckpt.committed_steps()
        ckpt.close()
        out.update(commits=commits, step_s=step_s, losses=losses,
                   snapshots=ckpt.snapshots, saved=saved,
                   step=manager.current_step(),
                   participating_rank=manager.participating_rank())
        sync = tft.DurableCheckpointer(
            cfg["store_sync"], manager, state, wire="bf16", mode="sync",
            device=device, commit_timeout_s=300.0,
            store=tft.LocalDirStore(cfg["store_sync"]))
        sync.save()
        sync.close()
        out["sync"] = sync.snapshots
    finally:
        manager.shutdown()
        collectives.shutdown()
    with open(os.path.join(workdir, f"result_{g}.json"), "w") as f:
        json.dump(out, f)


def phase_durable_flash(workdir: str, device: str = "cuda", lm: dict = BIG_LM,
                        batch: int = BIG_BATCH, seq: int = BIG_SEQ) -> dict:
    """Two groups write async durable sets of the big LM's state, then a
    fresh group (new replica id, width 1) cold-restores at its first
    quorum through the manager's durable consult."""
    import shutil

    import torchft_tpu_torch as tft
    from torchft_tpu_torch._tree import flatten
    from torchft_tpu_torch.models import transformer as tt

    free = shutil.disk_usage(workdir).free
    need = DURABLE_DISK_BYTES if lm is BIG_LM else 0
    if free < need:
        fail(f"durable flash: {free} B free under {workdir}, needs {need}")
    store, store_sync = (os.path.join(workdir, d) for d in ("store", "sync"))
    base = {"device": device, "role": "durable_flash", "lm": lm,
            "batch": batch, "seq": seq, "store": store,
            "store_sync": store_sync}
    res = _run_groups(workdir, base, [{}, {}])
    # the cold group: other weights, a new replica id, width 1
    dev = torch.device(device)
    model_cfg = tt.TransformerConfig(**lm)
    state = tft.FTTrainState(tt.TransformerLM(model_cfg, seed=1,
                                              device=dev).params(),
                             tft.AdamW(1e-3, weight_decay=1e-4))
    lighthouse = tft.Lighthouse(min_replicas=1, join_timeout_ms=100,
                                quorum_tick_ms=50, heartbeat_timeout_ms=10000)
    manager = tft.Manager(
        collectives=tft.DummyCollectives(), load_state_dict=state.load_state_dict,
        state_dict=state.state_dict, min_replica_size=1, rank=0, world_size=1,
        lighthouse_addr=lighthouse.address(), replica_id="cold0",
        device=dev, use_async_quorum=False)
    ckpt = tft.DurableCheckpointer(store, manager, state, device=dev,
                                   store=tft.LocalDirStore(store))
    try:
        t0 = time.perf_counter()
        manager.start_quorum()  # the consult restores here
        restore_s = time.perf_counter() - t0
        res["restore"] = {
            "step": manager.current_step(), "wall_s": restore_s,
            "stats": ckpt.last_restore_stats,
            "cold_restores": manager.metrics().snapshot()["counters"].get(
                "durable_cold_restores", 0),
            "params": _digest(state.params),
            "moments_k3": _k3_digest(state.opt_state),
            "count": state.opt_state["count"],
            "on_device": all(p.device.type == dev.type for p in
                             flatten(state.params)[0]),
        }
        res["disk_bytes"] = sum(
            os.path.getsize(os.path.join(d, f))
            for root in (store, store_sync) for d, _, fs in os.walk(root)
            for f in fs)
    finally:
        ckpt.close()
        manager.shutdown()
        lighthouse.shutdown()
    return res


def check_durable_flash(res: dict, on_card: bool = True) -> dict:
    results = res["results"]
    launches: dict = {}
    captures = [s for s in range(1, DURABLE_STEPS + 1) if s % DURABLE_EVERY == 0]
    for r in results:
        g, layers = r["group"], r["n_layers"]
        if not all(r["commits"]) or r["step"] != DURABLE_STEPS:
            fail(f"durable group {g}: commits {r['commits']} step {r['step']}")
        if not all(map(_finite, r["losses"])):
            fail(f"durable group {g}: non-finite loss {r['losses']}")
        if not r["flushed"]:
            fail(f"durable group {g}: the writer did not drain")
        rows = r["snapshots"]
        if [row["step"] for row in rows] != captures or not all(
                "write_s" in row and not row["aborted"] for row in rows):
            fail(f"durable group {g}: captures {rows}")
        if sorted(int(s) for s in r["saved"]) != captures:
            fail(f"durable group {g}: recorded {sorted(r['saved'])}")
        sync = r["sync"]
        if len(sync) != 1 or "write_s" not in sync[0] or sync[0]["aborted"]:
            fail(f"durable group {g}: sync baseline {sync}")
        want = dict.fromkeys(r["launches"], 0)
        if on_card:
            want.update(q8_absmax=DURABLE_STEPS, q8_quantize=DURABLE_STEPS,
                        flash_fwd=layers * DURABLE_STEPS,
                        flash_bwd=2 * layers * DURABLE_STEPS)
            want["cast_bf16"] = r["launches"].get("cast_bf16", 0)
        if r["launches"] != want:
            fail(f"durable group {g}: launches {r['launches']} != {want}")
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    # the member whose shard holds the moments narrows them: one K3 per
    # 64 moments per capture
    if on_card and launches.get("cast_bf16") != len(captures) * -(
            -DURABLE_MOMENTS // 64):
        fail(f"durable flash: K3 launched {launches.get('cast_bf16')} times")
    rank0 = next(r for r in results if r["participating_rank"] == 0)
    if rank0["committed_steps"] != captures[-DURABLE_KEEP:]:
        fail(f"durable flash: committed sets {rank0['committed_steps']}")
    if not all(row["committed"] for row in rank0["snapshots"]):
        fail(f"durable flash: rank 0's sets {rank0['snapshots']}")
    saved = {json.dumps(r["saved"][str(captures[-1])], sort_keys=True)
             for r in results}
    if len(saved) != 1:
        fail("durable flash: the groups captured different states")
    want = results[0]["saved"][str(captures[-1])]
    rs = res["restore"]
    if rs["step"] != captures[-1] or rs["cold_restores"] != 1:
        fail(f"durable flash: the cold group restored {rs}")
    if rs["params"] != want["params"]:
        fail("durable flash: restored params differ from the saved step's")
    if rs["moments_k3"] != want["moments_k3"]:
        fail("durable flash: restored moments are not K3 of the saved ones")
    if not rs["on_device"]:
        fail("durable flash: the restore did not land on the group's device")
    rows = [row for r in results for row in r["snapshots"]]
    sync = [r["sync"][0] for r in results]
    keys = ("stall_s", "capture_split", "write_s", "commit_s", "shard_bytes",
            "captured_bytes", "total_bytes")
    return {
        "launches": launches,
        "captures": [{k: row[k] for k in keys + ("rank", "step") if k in row}
                     for row in rows],
        "sync": [{k: row[k] for k in keys + ("rank",) if k in row}
                 for row in sync],
        "step_ms": [round(1e3 * s, 3) for r in results for s in r["step_s"]],
        "flush_s": [r["flush_s"] for r in results],
        "restore": {k: rs[k] for k in ("step", "wall_s", "stats")},
        "disk_bytes": res["disk_bytes"],
    }


def _plain_served(served, params, wire: str, snapshot: bool):
    """The publisher's served tree after one publish, through the wire
    kernels' plain versions (``plain_group``) on the same tensors: a
    snapshot is the decode of the params' encode, a delta ``served +
    decode(encode(params - served))`` with the subtraction, the decode's
    product and the add each rounded on its own."""
    from torchft_tpu_torch._tree import flatten, unflatten
    from torchft_tpu_torch.ops import quantize_kernels as qk

    leaves, treedef = flatten(params)
    cur = [l.detach().float().contiguous() for l in leaves]
    base = None if snapshot else flatten(served)[0]
    xs = cur if snapshot else [c - b for c, b in zip(cur, base)]
    counts = [x.numel() for x in xs]
    n, dev = sum(counts), xs[0].device
    if wire == "f32":
        dec = [x.clone() for x in xs]
    else:
        if wire == "q8":
            codes = torch.empty(n, dtype=torch.int8, device=dev)
            scales = torch.empty(len(xs), device=dev)
            qk.plain_group["quantize_q8"](xs, codes, scales)
            flat = torch.empty(n, device=dev)
            qk.plain_group["q8_dequantize"](codes, scales, counts, flat)
        else:
            words = torch.empty(n, dtype=torch.bfloat16, device=dev)
            qk.plain_group["cast_bf16"](xs, words)
            flat = words.float()
        dec = [v.view(x.shape) for v, x in zip(flat.split(counts), xs)]
    return unflatten(treedef, dec if snapshot
                     else [b + d for b, d in zip(base, dec)])


class _PublishTo:
    """publish_on_commit's target: forwards to the current wire's
    publisher, so one commit hook serves the phase's three wires. After
    each publish it advances the served tree through the plain versions
    (``_plain_served``) and notes whether the publisher's equals it bit
    for bit (a hook's exception would be logged and dropped, so the
    phase reads ``plain_equal``)."""

    def __init__(self) -> None:
        self.use(None)

    def use(self, publisher) -> None:
        self.publisher, self.plain, self.plain_equal = publisher, None, []

    def publish(self, params, step=None):
        m = self.publisher.publish(params, step=step)
        self.plain = _plain_served(self.plain, params, self.publisher.wire,
                                   m["kind"] == "snapshot")
        self.plain_equal.append(_tree_bits_equal(self.plain,
                                                 self.publisher.served()))
        return m


def _tree_bits_equal(a, b) -> bool:
    from torchft_tpu_torch._tree import flatten

    la, da = flatten(a)
    lb, db = flatten(b)
    return da == db and all(_bits_equal(x, y) for x, y in zip(la, lb))


def _concurrently(fns) -> list:
    """Runs the callables on threads at once; their results in order (an
    exception raises here)."""
    out: list = [None] * len(fns)
    errors: list = []

    def run(i: int) -> None:
        try:
            out[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def phase_serving_flash(device: str = "cuda", lm: dict = BIG_LM,
                        batch: int = BIG_BATCH, seq: int = BIG_SEQ,
                        versions: int = SERVE_VERSIONS) -> dict:
    """A training group (this process, one member) publishes its params
    through publish_on_commit at every committed step: SERVE_VERSIONS
    versions per wire, a WeightRelay between the publisher and two
    subscribers, a third subscriber on the publisher (the relay's sync
    beside the third's install, then the relay's two at once); the
    publisher's served tree is checked against the plain versions' after
    every publish, and every subscriber installs on the card and is
    checked against the publisher's served tree after every version."""
    import torchft_tpu_torch as tft
    from torchft_tpu_torch import serving as sv
    from torchft_tpu_torch.models import transformer as tt
    from torchft_tpu_torch.ops import quantize_kernels as qk

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    model_cfg = tt.TransformerConfig(**lm)
    state = tft.FTTrainState(tt.TransformerLM(model_cfg, seed=0,
                                              device=dev).params(),
                             tft.AdamW(1e-3, weight_decay=1e-4))
    grad_fn = tt.make_grad_fn(model_cfg)
    lighthouse = tft.Lighthouse(min_replicas=1, join_timeout_ms=100,
                                quorum_tick_ms=50, heartbeat_timeout_ms=10000)
    manager = tft.Manager(
        collectives=tft.DummyCollectives(), load_state_dict=state.load_state_dict,
        state_dict=state.state_dict, min_replica_size=1, rank=0, world_size=1,
        lighthouse_addr=lighthouse.address(), replica_id="trainer",
        device=dev, use_async_quorum=False)
    target = _PublishTo()
    sv.publish_on_commit(manager, target, lambda: state.params)
    cfg = {"group": 0, "lm": lm, "batch": batch, "seq": seq}
    out: dict = {"wires": {}}
    step_i = [0]

    def train_step() -> bool:
        manager.start_quorum()
        _, grads = grad_fn(state.params, _tokens(cfg, step_i[0], dev))
        step_i[0] += 1
        avg = manager.allreduce(grads).wait()
        committed = manager.should_commit()  # the hook publishes here
        if committed:
            state.apply_gradients(avg)
        return committed

    try:
        qk.reset_launch_counts()
        t_phase = time.perf_counter()
        for wire in SERVE_WIRES:
            pub = sv.WeightPublisher(wire=wire,
                                     snapshot_every=SERVE_SNAPSHOT_EVERY)
            relay = sv.WeightRelay(pub.server.local_address(), timeout_s=120.0)
            subs = [sv.WeightSubscriber(relay.server.local_address(),
                                        device=dev, timeout_s=120.0,
                                        name=f"relay-sub{i}")
                    for i in range(2)]
            subs.append(sv.WeightSubscriber(pub.server.local_address(),
                                            device=dev, timeout_s=120.0,
                                            name="direct-sub"))
            target.use(pub)
            rows = []
            try:
                for v in range(versions):
                    if not train_step():
                        fail(f"serving flash {wire}: step {v} did not commit")
                    if target.plain_equal != [True] * (v + 1):
                        fail(f"serving flash {wire} v{v}: the publisher's "
                             "served tree differs from the plain versions' "
                             f"({target.plain_equal})")
                    m = pub.node.store.get(v).manifest
                    # the relay's sync beside the direct subscriber's
                    # install, then the relay's two subscribers at once:
                    # independent clients, as they would run
                    timed: dict = {}

                    def sync() -> None:
                        t0 = time.perf_counter()
                        relay.sync_once()
                        timed["relay_s"] = time.perf_counter() - t0

                    polled = _concurrently([sync, subs[2].poll])
                    polled = _concurrently([subs[0].poll, subs[1].poll]) \
                        + polled[1:]
                    relay_s = timed["relay_s"]
                    installs = []
                    for s, ok in zip(subs, polled):
                        if not ok:
                            fail(f"serving flash {wire} v{v}: {s.name} did "
                                 f"not install ({s.stats})")
                        version, tree, _ = s.current()
                        if version != v or sv.tree_digest(tree) != m["digest"]:
                            fail(f"serving flash {wire} v{v}: {s.name} digest")
                        if not _tree_bits_equal(tree, pub.served()):
                            fail(f"serving flash {wire} v{v}: {s.name} differs "
                                 "from the publisher's served tree")
                        installs.append(s.last_install)
                    rows.append({"version": v, "kind": m["kind"],
                                 "wire_bytes": m["total"],
                                 "f32_bytes": m["f32_nbytes"],
                                 "publish": pub.last_publish,
                                 "relay_sync_s": relay_s,
                                 "installs": installs})
                out["wires"][wire] = {
                    "rows": rows,
                    "subscribers": {s.name: dict(s.stats) for s in subs},
                    "relay": relay.node.status()["counters"],
                    "publisher": pub.status()["counters"],
                }
            finally:
                for s in subs:
                    s.close()
                relay.shutdown()
                pub.shutdown()
        if on_card:
            torch.cuda.synchronize()
        out["launches"] = dict(qk.launch_counts)
        out["total_s"] = time.perf_counter() - t_phase
        out["n_layers"] = len(state.params["blocks"])
    finally:
        manager.shutdown()
        lighthouse.shutdown()
    return out


def check_serving_flash(res: dict, on_card: bool = True,
                        versions: int = SERVE_VERSIONS) -> dict:
    summary: dict = {"launches": res["launches"], "wires": {}}
    for wire, w in res["wires"].items():
        for name, st in w["subscribers"].items():
            if st["installs"] != versions or st["torn_installs"] != 0:
                fail(f"serving flash {wire}: {name} {st}")
        if w["relay"]["syncs"] != versions:
            fail(f"serving flash {wire}: the relay fetched {w['relay']}")
        kinds = [r["kind"] for r in w["rows"]]
        if kinds != ["snapshot" if v % SERVE_SNAPSHOT_EVERY == 0 else "delta"
                     for v in range(versions)]:
            fail(f"serving flash {wire}: kinds {kinds}")
        summary["wires"][wire] = [{
            "v": r["version"], "kind": r["kind"], "wire_bytes": r["wire_bytes"],
            "publish_ms": {k: round(1e3 * r["publish"][k], 3) for k in
                           ("wait_s", "encode_s", "staging_s", "crc_s",
                            "digest_s", "total_s")},
            "relay_sync_ms": round(1e3 * r["relay_sync_s"], 3),
            "install_ms": [{k: round(1e3 * i[k], 3) for k in
                            ("fetch_s", "decode_s", "digest_s")}
                           for i in r["installs"]],
            "bytes_per_subscriber": [i["bytes"] for i in r["installs"]],
        } for r in w["rows"]]
    n = len(SERVE_WIRES) * versions
    layers = res["n_layers"]
    if on_card:
        q8 = versions  # one encode per q8 publish
        want = {"q8_absmax": q8, "q8_quantize": q8,
                # the publisher's decode of every q8 version, and every
                # subscriber's install of it
                "q8_dequantize": q8 * (1 + 3), "cast_bf16": versions,
                "flash_fwd": layers * n, "flash_bwd": 2 * layers * n}
        got = {k: res["launches"].get(k, 0) for k in want}
        if got != want:
            fail(f"serving flash: launches {got} != {want}")
    return summary


def phase_parameter_server(device: str = "cuda", lm: dict = BIG_LM) -> dict:
    """A ParameterServer session over the ring shares the big LM's largest
    leaf (on the card) from server to client and back; a subscriber of
    serving_address() installs one published version of the LM."""
    import torchft_tpu_torch as tft
    from torchft_tpu_torch import serving as sv
    from torchft_tpu_torch._tree import flatten
    from torchft_tpu_torch.models import transformer as tt
    from torchft_tpu_torch.ops import quantize_kernels as qk

    dev = torch.device(device)
    params = tt.TransformerLM(tt.TransformerConfig(**lm), seed=0,
                              device=dev).params()
    leaf = max(flatten(params)[0], key=lambda t: t.numel()).detach().clone()
    back: dict = {}
    done = threading.Event()

    class _Server(tft.ParameterServer):
        @classmethod
        def new_collectives(cls):
            return tft.HostCollectives()

        def forward(self, session_id, collectives):
            try:
                collectives.broadcast(leaf, root=0).wait()
                back["leaf"] = collectives.broadcast(
                    torch.empty_like(leaf), root=1).wait()
            finally:
                done.set()

    out: dict = {"leaf_numel": leaf.numel()}
    qk.reset_launch_counts()
    server = _Server(wire="q8", snapshot_every=4)
    try:
        port = server.publisher.server.port
        t0 = time.perf_counter()
        client = _Server.new_session(f"http://[::1]:{port}/new_session")
        got = client.broadcast(torch.empty_like(leaf), root=0).wait()
        client.broadcast(got, root=1).wait()
        if not done.wait(120):
            fail("parameter server: the session did not finish")
        out["session_s"] = time.perf_counter() - t0
        client.shutdown()
        out["client_bits"] = _bits_equal(got.to(dev), leaf)
        out["server_bits"] = _bits_equal(back["leaf"].to(dev), leaf)
        out["client_on_device"] = got.device.type == dev.type
        t0 = time.perf_counter()
        m = server.publish(params, step=0)
        out["publish_s"] = time.perf_counter() - t0
        sub = sv.WeightSubscriber(f"http://[::1]:{port}", device=dev,
                                  timeout_s=120.0)
        try:
            out["installed"] = sub.poll()
            _, tree, _ = sub.current()
            out["digest_ok"] = sv.tree_digest(tree) == m["digest"]
            out["served_bits"] = _tree_bits_equal(tree,
                                                  server.publisher.served())
            out["install"] = sub.last_install
            out["stats"] = dict(sub.stats)
        finally:
            sub.close()
        out["serving_address"] = server.serving_address()
    finally:
        server.shutdown()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["launches"] = dict(qk.launch_counts)
    return out


def check_parameter_server(res: dict, on_card: bool = True) -> dict:
    for k in ("client_bits", "server_bits", "client_on_device", "installed",
              "digest_ok", "served_bits"):
        if not res[k]:
            fail(f"parameter server: {k} failed ({res})")
    if res["stats"]["torn_installs"]:
        fail(f"parameter server: {res['stats']}")
    if on_card:
        want = {"q8_absmax": 1, "q8_quantize": 1, "q8_dequantize": 2}
        got = {k: res["launches"].get(k, 0) for k in want}
        if got != want:
            fail(f"parameter server: launches {got} != {want}")
    return {"launches": res["launches"],
            **{k: res[k] for k in ("leaf_numel", "session_s", "publish_s",
                                   "install")}}


def serving_phases(by_phase: dict) -> None:
    """The durable flash, serving flash and parameter server phases: each
    runs, is checked and logged, and puts its launch counts into
    ``by_phase``."""
    _phase("durable flash")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_durable_") as workdir:
        t0 = time.perf_counter()
        dres = phase_durable_flash(workdir)
        dsum = check_durable_flash(dres)
        d_s = time.perf_counter() - t0
    by_phase["durable flash"] = dsum["launches"]
    log(f"  durable flash {d_s:.1f} s (two groups, PipelinedDDP(q8) blocking "
        f"steps, DurableCheckpointer(async, bf16 wire, every "
        f"{DURABLE_EVERY}, keep {DURABLE_KEEP}, register_hook) into a "
        f"LocalDirStore, {dsum['disk_bytes']} B on disk); async captures "
        f"{json.dumps(dsum['captures'])}; sync baseline "
        f"{json.dumps(dsum['sync'])}; step ms {dsum['step_ms']}; writer "
        f"flush s {dsum['flush_s']}; cold restore at width 1 "
        f"{json.dumps(dsum['restore'])}")
    _phase("serving flash")
    sres = phase_serving_flash()
    ssum = check_serving_flash(sres)
    by_phase["serving flash"] = ssum["launches"]
    log(f"  serving flash {sres['total_s']:.1f} s ({SERVE_VERSIONS} versions "
        f"per wire from publish_on_commit, snapshot_every "
        f"{SERVE_SNAPSHOT_EVERY}, a relay and two subscribers behind it, a "
        f"third on the publisher, all installing on the card)")
    for wire, rows in ssum["wires"].items():
        log(f"  serving {wire}: {json.dumps(rows)}")
    _phase("parameter server")
    pres = phase_parameter_server()
    psum = check_parameter_server(pres)
    by_phase["parameter server"] = psum["launches"]
    log(f"  parameter server: {json.dumps(psum)}")


# -- the durable control plane, the chaos plane, the policy engine ---------------

# control dense: group 1's primary dies once both groups committed
# CONTROL_KILL_STEP steps; the active root dies CONTROL_ROOT_KILL_AFTER
# commits after the promoted spare's first; every group then takes
# CONTROL_TAIL_STEPS more steps. The cold run kills at the same step.
CONTROL_KILL_STEP = 4
CONTROL_ROOT_KILL_AFTER = 3
CONTROL_TAIL_STEPS = 2
CONTROL_LEASE_MS = 1000      # the managers' lease: a dead group leaves fast
CONTROL_TAKEOVER_MS = 1500   # the standby root's sync-starvation bound
CONTROL_LR = 1e-3            # the workers' AdamW rate (the drift bound)
# a ring configure waits this long for a member that registered its
# next quorum intent and then died (async quorum: the intent goes out at
# the top of the step), then the step fails and the next quorum drops it
CONTROL_CONNECT_S = 3
# a quorum round or a ring op that outlives these raises or fails the
# step, and the worker retries: through the region tier a member's
# quorum request can arrive after the root formed the quorum from its
# previous intent, and it then waits for a newer one (ROADMAP Queue 3,
# R1) while its peer waits in the ring (a dense step's ring is ~60 ms)
CONTROL_QUORUM_TIMEOUT_S = 10
CONTROL_OP_TIMEOUT_S = 10
# through the region tier a failed member's forced registration is
# forwarded again with every digest while the member heartbeats, so the
# root forms a new quorum id each poll (ROADMAP Queue 3, R1): two members
# that retry a moment apart configure for different ids and time out,
# round after round. After a second failed step in a row a worker retries
# on this shared clock tick, longer than a failed attempt's configure
# bound, so both members' requests reach their regions together
CONTROL_RETRY_TICK_S = 4.0
# chaos flash: the plan's faults land at attempted steps 1..6, one each;
# the SIGKILL of group 1 at CHAOS_KILL_STEP; CHAOS_TAIL_STEPS clean steps
# after the restarted group's first commit
CHAOS_SEED = 1212
CHAOS_KINDS = (("ring_send", "bit_flip"), ("ring_send", "duplicate"),
               ("ring_send", "drop"), ("ring_send", "delay"),
               ("ring_send", "truncate"), ("ring_hdr", "bit_flip"))
CHAOS_KILL_STEP = 8
CHAOS_TAIL_STEPS = 2
# chaos flash and policy flash run the big LM at this depth (8 layers:
# 85-101 s for the two, 4 layers 70-93 s)
CHAOS_LM = {**BIG_LM, "n_layers": 2}
# a ring op's deadline: a dropped frame can cost one, and the donor's op
# must outlast the restarted group's heal inside its sync quorum (the
# 1.33 GB fetch falling back to the striped path, ~6 s on the card)
CHAOS_OP_TIMEOUT_S = 20.0
CORRUPTING_KINDS = ("bit_flip", "duplicate")
# policy flash: two candidates, a decision every 4 attempted steps, the
# windowed one on 4-step windows; POLICY_STEPS ends on a window's sync
POLICY_DECIDE_EVERY = 4
POLICY_SYNC_EVERY = 4
POLICY_STEPS = 8
# the knob that makes the switch: a per-sync fixed cost of 0.5 s (the
# model's default is 2 ms) charges every per-step sync and a quarter of
# it to a 4-step window
POLICY_KNOBS = {"sync_fixed_s": 0.5}


def _checksum(params) -> int:
    """An exact fingerprint of the params' bits, folded on the device
    (the leaves' int32 words summed in int64), cheap enough to take at a
    heal."""
    from torchft_tpu_torch._tree import flatten

    total = 0
    for p in flatten(params)[0]:
        s = int(p.detach().reshape(-1).view(torch.int32).to(torch.int64).sum())
        total = (total * 1000003 + s) % (1 << 64)
    return total


def _smi_used_bytes() -> "int | None":
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=20).stdout
        return int(float(out.strip().splitlines()[0])) << 20
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _context_bytes() -> "int | None":
    """What one more process's CUDA context takes on the card: the card's
    used memory before and after a fresh process creates its context
    (one small allocation), less that allocation's pool, with no other
    worker running. Every spare pays it on top of its warm-up."""
    code = (
        "import json, torch, chip_smoke as cs\n"
        "before = cs._smi_used_bytes()\n"
        "torch.empty(1, device='cuda')\n"
        "torch.cuda.synchronize()\n"
        "after = cs._smi_used_bytes()\n"
        "print(json.dumps([before, after, torch.cuda.memory_reserved()]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    try:
        before, after, reserved = json.loads(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return None
    if before is None or after is None:
        return None
    return after - before - reserved


def _read_stop(workdir: str) -> "int | None":
    try:
        with open(os.path.join(workdir, "stop")) as f:
            return int(f.read())
    except (OSError, ValueError):
        return None


def _write_stop(workdir: str, step: int) -> None:
    """Tells the launched groups to stop once they reach ``step``."""
    with open(os.path.join(workdir, "stop.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(workdir, "stop.tmp"),
               os.path.join(workdir, "stop"))


def _progress(workdir: str, g: int) -> list:
    try:
        with open(os.path.join(workdir, f"progress_{g}.jsonl")) as f:
            return [json.loads(l) for l in f if l.strip()]
    except OSError:
        return []


def _guarded_step(ddp, manager, tokens) -> tuple:
    """One blocking step. A step that raises (a peer died mid-quorum, a
    fault surfaced) is reported to the manager and voted down, and the
    worker retries. Returns (committed, the step's error or None)."""
    try:
        ddp.blocking_step(tokens)
        return bool(ddp.last_commit), manager.errored()
    except Exception as e:  # noqa: BLE001 - the worker retries
        try:
            if manager.errored() is None:
                manager.report_error(e)
            manager.should_commit()
        except Exception:  # noqa: BLE001
            pass
        return False, e


def _txn_row(manager, t0: float, committed: bool, err) -> dict:
    """One transaction's progress row. ``qid`` is the quorum's id as
    configured: ``quorum_id()`` would re-raise a failed quorum."""
    return {"t0": t0, "t": time.time(), "pid": os.getpid(),
            "step": manager.current_step(), "qid": manager._quorum_id,
            "committed": committed,
            "err": f"{type(err).__name__}: {err}" if err is not None else None}


def control_worker(cfg: dict) -> None:
    """One process of a launched replica group (``launch`` sets
    REPLICA_GROUP_ID, TORCHFT_LIGHTHOUSE, TORCHFT_LIGHTHOUSE_ROOT,
    TORCHFT_REGION, and TORCHFT_STANDBY_FILE on a hot spare). A spare
    warms on the card (``HostCollectives.prewarm`` and
    ``FTTrainState.warm`` on zero gradients), records its memory and
    parks at ``standby_gate()``; a primary (or a promoted spare) trains
    on PipelinedDDP(compress="q8") blocking steps until the stop file's
    step, logging every transaction to ``progress_<group>.jsonl``."""
    os.environ.update(cfg.get("env", {}))
    import torchft_tpu_torch as tft
    from torchft_tpu_torch import platform as tplat
    from torchft_tpu_torch._tree import flatten, tree_map
    from torchft_tpu_torch.models import transformer as tt
    from torchft_tpu_torch.ops import quantize_kernels as qk
    from datetime import timedelta

    g = int(os.environ["REPLICA_GROUP_ID"])
    workdir = cfg["workdir"]
    device = torch.device(cfg["device"])
    on_card = device.type == "cuda"
    standby = bool(os.environ.get("TORCHFT_STANDBY_FILE"))
    tag = f"{g}_{os.getpid()}"
    info: dict = {"group": g, "pid": os.getpid(), "standby": standby,
                  "t_start": time.time()}
    qk.reset_launch_counts()
    model_cfg = tt.TransformerConfig(**cfg["lm"])
    model = tt.TransformerLM(model_cfg, seed=0, device=device)
    state = tft.FTTrainState(model.params(),
                             tft.AdamW(CONTROL_LR, weight_decay=1e-4))
    collectives = tft.HostCollectives(
        timeout=timedelta(seconds=CONTROL_OP_TIMEOUT_S),
        connect_timeout=timedelta(seconds=CONTROL_CONNECT_S))
    if standby and tplat.standby_should_warm():
        t0 = time.perf_counter()
        if on_card:
            torch.cuda.synchronize(device)
            info["reserved_before_warm"] = torch.cuda.memory_reserved(device)
        grads_like = tree_map(torch.zeros_like, state.params)
        collectives.prewarm(grads_like, wire="q8ef")
        state.warm(grads_like)
        if on_card:
            torch.cuda.synchronize(device)
            info["reserved_after_warm"] = torch.cuda.memory_reserved(device)
        info["warm_s"] = time.perf_counter() - t0
        info["warm_launches"] = dict(qk.launch_counts)
        with open(os.path.join(workdir, f"standby_{tag}.json"), "w") as f:
            json.dump(info, f)
    tplat.standby_gate()
    info["t_gate"] = time.time()
    healed: list = []
    box: dict = {}
    # every state this group serves, as it serves it (a donor may die
    # before its result is written)
    served = open(os.path.join(workdir, f"served_{g}.jsonl"), "a")

    def state_dict():
        served.write(json.dumps({"pid": os.getpid(),
                                 "step": box["m"].current_step(),
                                 "checksum": _checksum(state.params)}) + "\n")
        served.flush()
        return state.state_dict()

    def load_state_dict(sd):
        state.load_state_dict(sd)
        healed.append({"checksum": _checksum(state.params),
                       "t": time.time()})

    manager = box["m"] = tft.Manager(
        collectives=collectives, load_state_dict=load_state_dict,
        state_dict=state_dict, min_replica_size=2, rank=0, world_size=1,
        replica_id=f"g{g}", device=device,
        timeout=timedelta(seconds=CONTROL_OP_TIMEOUT_S),
        quorum_timeout=timedelta(seconds=CONTROL_QUORUM_TIMEOUT_S))
    model_grad = tt.make_grad_fn(model_cfg)
    ddp = tft.PipelinedDDP(manager, state, model_grad, compress="q8",
                           transport="plan", device_pack=True)
    prog = open(os.path.join(workdir, f"progress_{g}.jsonl"), "a")
    data = {"group": g, "lm": cfg["lm"], "batch": cfg["batch"],
            "seq": cfg["seq"]}
    heals_seen, first_row, failed = 0, True, 0
    try:
        while True:
            stop = _read_stop(workdir)
            if stop is not None and manager.current_step() >= stop:
                break
            if failed >= 2:
                time.sleep(CONTROL_RETRY_TICK_S
                           - time.time() % CONTROL_RETRY_TICK_S)
            t0 = time.time()
            committed, err = _guarded_step(
                ddp, manager, _tokens(data, manager.current_step(), device))
            failed = failed + 1 if err is not None else 0
            row = _txn_row(manager, t0, committed, err)
            if first_row:  # when this process started and left the gate
                first_row = False
                row.update({k: info[k] for k in ("t_start", "t_gate")})
            if len(healed) > heals_seen:
                heals_seen = len(healed)
                row["heal"] = {
                    **(manager.checkpoint_transport().last_fetch_stats or {}),
                    "checksum": healed[-1]["checksum"]}
            prog.write(json.dumps(row) + "\n")
            prog.flush()
        if on_card:
            torch.cuda.synchronize(device)
        info.update({
            "launches": dict(qk.launch_counts),
            "step": manager.current_step(), "digest": _digest(state.params),
            "heals": manager.metrics().snapshot()["counters"].get("heals", 0),
        })
        # the final params, for the drift bound across a bf16-wire heal
        torch.save([p.detach().cpu() for p in flatten(state.params)[0]],
                   os.path.join(workdir, f"params_{tag}.pt"))
        if on_card:
            info["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                device)
    finally:
        prog.close()
        served.close()
        manager.shutdown()
        collectives.shutdown()
    with open(os.path.join(workdir, f"result_{tag}.json"), "w") as f:
        json.dump(info, f)


def _wait_progress(workdir: str, pred, timeout_s: float, what: str,
                   watch=None, detail=None) -> dict:
    """Polls the groups' progress logs until ``pred(logs)`` returns a
    truthy value; fails after ``timeout_s`` (with ``detail()`` in the
    message) or when ``watch()`` says the run is gone."""
    deadline = time.monotonic() + timeout_s
    while True:
        logs = {g: _progress(workdir, g) for g in (0, 1)}
        v = pred(logs)
        if v:
            return v
        if watch is not None and watch():
            fail(f"control run ended while waiting for {what}")
        if time.monotonic() > deadline:
            fail(f"timed out waiting for {what}: "
                 f"{ {g: l[-3:] for g, l in logs.items()} }"
                 + (f"; {detail()}" if detail is not None else ""))
        time.sleep(0.05)


def _committed(log_rows: list, after: float = 0.0, pid=None) -> list:
    return [r for r in log_rows if r["committed"] and r["t"] > after
            and (pid is None or r["pid"] == pid)]


def _control_run(workdir: str, lighthouse_addr: str, hot: bool, base: dict,
                 roots=None) -> dict:
    """One launched run of two dense groups: ``hot`` with a spare per
    group, two in-process regions and the root failover set (``roots``:
    the active and the standby RootProcess). Group 1's process dies at
    CONTROL_KILL_STEP; in the hot run the active root dies next. Group 0
    never dies: the reference the promoted group is held to. Cold:
    restarts only."""
    from torchft_tpu_torch import launcher
    from torchft_tpu_torch.chaos import kill_process

    os.makedirs(workdir, exist_ok=True)
    cfg = {**base, "workdir": workdir}
    if hot:
        cfg["env"] = {**cfg.get("env", {}), "TORCHFT_HEAL_WIRE": "bf16"}
    cmd = [sys.executable, os.path.abspath(__file__), "--control-worker",
           json.dumps(cfg)]
    result: dict = {}
    kw = {"hot_spare": True, "regions": 2,
          "root_addrs": ",".join(r.address() for r in roots)} if hot else {}

    def run() -> None:
        result["rc"] = launcher.launch(cmd, 2, lighthouse_addr,
                                       max_restarts=2, **kw)

    t0 = time.perf_counter()
    th = threading.Thread(target=run, daemon=True)
    th.start()
    gone = lambda: not th.is_alive()  # noqa: E731
    out: dict = {"hot": hot}
    try:
        _wait_progress(workdir, lambda logs: all(
            len(_committed(logs[g])) >= CONTROL_KILL_STEP for g in (0, 1)),
            300, "both groups' first steps", gone)
        if hot:  # promote a spare that finished its warm-up
            _wait_progress(workdir, lambda _: [
                f for f in os.listdir(workdir) if f.startswith("standby_1_")],
                300, "group 1's warm spare", gone)
        victim = _progress(workdir, 1)[-1]["pid"]
        t_kill = time.time()
        kill_process(victim)
        first = _wait_progress(
            workdir, lambda logs: next(iter(
                [r for r in _committed(logs[1], t_kill)
                 if r["pid"] != victim]), None), 300,
            "the replacement's first commit", gone,
            lambda: {r.address(): r.status(timeout=0.5) for r in roots or []})
        heal = _wait_progress(workdir, lambda logs: next(iter(
            [r["heal"] for r in logs[1] if r["pid"] == first["pid"]
             and "heal" in r]), None), 60, "the replacement's heal", gone)
        out["replacement"] = {"t_kill": t_kill, "pid": first["pid"],
                              "kill_to_first_commit_s": first["t"] - t_kill,
                              "heal": heal}
        if hot:
            _wait_progress(workdir, lambda logs: len(_committed(
                logs[1], t_kill, first["pid"])) >= CONTROL_ROOT_KILL_AFTER,
                120, "commits after the promotion", gone)
            active, standby = roots
            t_root = time.time()
            active.kill()
            while not (standby.status(timeout=0.5) or {}).get("active"):
                if time.time() - t_root > 60:
                    fail("the standby root never took over")
                time.sleep(0.02)
            out["takeover_s"] = time.time() - t_root
            # failed over: both groups' leases are live at the new active root
            # again (their regions' digests, or a demoted manager's own
            # renewal); the leases it mirrored from the dead root lapsed
            # before the takeover (CONTROL_LEASE_MS < CONTROL_TAKEOVER_MS)
            def both_at_standby() -> bool:
                st = standby.status(timeout=0.5) or {}
                ids = {m["replica_id"].split(":")[0]
                       for m in st.get("members", [])
                       if m.get("lease_remaining_ms", 0) > 0}
                return {"g0", "g1"} <= ids
            while not both_at_standby():
                if time.time() - t_root > 60:
                    fail(f"the fleet never registered at the standby root: "
                         f"{standby.status()}")
                time.sleep(0.02)
            out["root_failover_s"] = time.time() - t_root
            after = _wait_progress(workdir, lambda logs: all(
                _committed(logs[g], t_root) for g in (0, 1)) and logs, 120,
                "commits after the root failover", gone)
            out["first_commits_after_root_kill_s"] = [round(
                _committed(after[g], t_root)[0]["t"] - t_root, 3)
                for g in (0, 1)]
            st = standby.status() or {}
            out["standby_root"] = {k: st.get(k) for k in (
                "role", "active", "root_epoch", "quorum_id", "wal_replayed")}
            out["standby_root"]["regions"] = sorted(
                r.get("region_id") for r in st.get("regions", []))
        last = max(r["step"] for g in (0, 1) for r in _progress(workdir, g))
        _write_stop(workdir, last + CONTROL_TAIL_STEPS)
    except BaseException:
        _write_stop(workdir, 0)  # the groups leave at their next step
        th.join(120)
        raise
    th.join(300)
    if th.is_alive() or result.get("rc") != 0:
        fail(f"the launched groups did not exit cleanly: {result}")
    out["total_s"] = time.perf_counter() - t0
    out["logs"] = {g: _progress(workdir, g) for g in (0, 1)}
    out["results"] = []
    out["standbys"] = []
    out["served"] = {}
    for name in sorted(os.listdir(workdir)):
        path = os.path.join(workdir, name)
        if name.startswith("result_"):
            with open(path) as f:
                r = json.load(f)
            r["params_file"] = os.path.join(
                workdir, "params_" + name[len("result_"):-5] + ".pt")
            out["results"].append(r)
        elif name.startswith("standby_"):
            with open(path) as f:
                out["standbys"].append(json.load(f))
        elif name.startswith("served_"):
            with open(path) as f:
                out["served"][int(name[len("served_"):-6])] = [
                    json.loads(l) for l in f if l.strip()]
    return out


def phase_control_dense(workdir: str, device: str = "cuda", lm: dict = LM,
                        batch: int = BATCH, seq: int = SEQ) -> dict:
    """The hot run (spares, two regions, a WAL'd active root and a standby
    root as processes) then the cold run (restarts only, a flat
    in-process lighthouse) of the same two dense groups. Every quorum
    holds both groups (``min_replicas=2``): the survivor waits for the
    replacement instead of training alone."""
    import torchft_tpu_torch as tft
    from torchft_tpu_torch.chaos import RootProcess, free_port

    base = {"device": device, "lm": lm, "batch": batch, "seq": seq,
            "env": {"TORCHFT_LEASE_TTL_MS": str(CONTROL_LEASE_MS)}}
    context = _context_bytes() if device == "cuda" else None
    t0 = time.perf_counter()
    ports = [free_port(), free_port()]
    addrs = [f"http://localhost:{p}" for p in ports]
    roots = []
    try:
        for i in (0, 1):
            roots.append(RootProcess(
                ports[i], wal_dir=os.path.join(workdir, f"wal_{i}"),
                peers=addrs[1 - i], standby=i == 1,
                takeover_ms=CONTROL_TAKEOVER_MS, join_timeout_ms=2000,
                heartbeat_timeout_ms=CONTROL_LEASE_MS, min_replicas=2))
            roots[-1].wait_serving()
        hot = _control_run(os.path.join(workdir, "hot"), addrs[0], True, base,
                           roots)
    finally:
        for r in roots:
            r.stop()
    lighthouse = tft.Lighthouse(min_replicas=2, join_timeout_ms=2000,
                                heartbeat_timeout_ms=CONTROL_LEASE_MS)
    try:
        cold = _control_run(os.path.join(workdir, "cold"),
                            lighthouse.address(), False, base)
    finally:
        lighthouse.shutdown()
    return {"hot": hot, "cold": cold, "total_s": time.perf_counter() - t0,
            "context_bytes": context}


def _param_drift(a: str, b: str) -> float:
    return max(float((x - y).abs().max()) for x, y in
               zip(torch.load(a), torch.load(b)))


def _bf16_heal_drift_bound(steps: int, lr: float = CONTROL_LR,
                           b1: float = 0.9, b2: float = 0.999) -> float:
    """How far two AdamW trajectories can part in ``steps`` steps after a
    bf16-wire heal, which hands the healer the donor's params bit for bit
    and its moments rounded to bf16 (relative error at most 2^-8). Both
    groups apply the same averaged gradient, so only the rounding parts
    them: it changes the ratio mu / sqrt(nu) by at most 2^-8 + 2^-9 of
    its size and decays after, and that ratio is at most
    (1 - b1) / sqrt((1 - b2) (1 - b1^2 / b2)) for moments built from any
    gradients (Cauchy-Schwarz), the bias corrections only shrinking it.
    2^-7 in place of 2^-8 + 2^-9 leaves room for the f32 roundings. A
    skipped update or another gradient moves a param by about lr a step,
    some 17 times this bound's step."""
    ratio = (1 - b1) / ((1 - b2) * (1 - b1 * b1 / b2)) ** 0.5
    return steps * lr * ratio * 2.0 ** -7


def check_control_dense(res: dict, on_card: bool = True) -> dict:
    launches: dict = {}
    summary: dict = {}
    for name in ("hot", "cold"):
        run = res[name]
        # every quorum id a group committed under only goes up
        for g, rows in run["logs"].items():
            qids = [r["qid"] for r in rows if r["committed"]]
            if qids != sorted(qids):
                fail(f"control {name}: group {g}'s quorum_id went back: {qids}")
        # every heal (the replacement's, and any a quorum round forced)
        # took the stream path and landed a state the other group served
        for g, rows in run["logs"].items():
            served = {x["checksum"] for x in run["served"].get(1 - g, [])}
            for heal in (r["heal"] for r in rows if "heal" in r):
                if heal.get("path") != "stream":
                    fail(f"control {name}: group {g} healed off the stream "
                         f"path: {heal}")
                if heal["checksum"] not in served:
                    fail(f"control {name}: group {g}'s healed params "
                         f"{heal['checksum']} are not a state the donor "
                         f"served {sorted(served)}")
        # each group's last process (a crashed replacement is replaced)
        by_group = {}
        for r in sorted(run["results"], key=lambda r: r["t_gate"]):
            by_group[r["group"]] = r
        if sorted(by_group) != [0, 1]:
            fail(f"control {name}: results of groups {sorted(by_group)}")
        r0, r1 = by_group[0], by_group[1]
        if r0["step"] != r1["step"]:
            fail(f"control {name}: groups ended at steps {r0['step']}, "
                 f"{r1['step']}")
        # the last heal of either group made the params equal; its
        # healer's commits since count the steps the rounded moments had
        # to part them
        t_heal, g_heal, pid_heal = max(
            (r["t"], g, r["pid"]) for g, rows in run["logs"].items()
            for r in rows if "heal" in r)
        last = next(r["heal"] for r in run["logs"][g_heal]
                    if r["t"] == t_heal and "heal" in r)
        drift = bound = 0.0
        if name == "cold" or last.get("wire") != "bf16":
            if r0["digest"] != r1["digest"]:
                fail(f"control {name}: the groups do not end bit-identical")
        else:
            after = sum(1 for r in run["logs"][g_heal] if r["pid"] == pid_heal
                        and r["committed"] and r["t"] >= t_heal)
            drift = _param_drift(r0["params_file"], r1["params_file"])
            bound = _bf16_heal_drift_bound(after)
            if drift > bound:
                fail(f"control {name}: params drifted {drift} > {bound} "
                     f"after {after} steps past the bf16-wire heal")
        for r in run["results"]:
            for k, n in r.get("launches", {}).items():
                launches[k] = launches.get(k, 0) + n
        row = {k: run.get(k) for k in (
            "takeover_s", "root_failover_s",
            "first_commits_after_root_kill_s", "standby_root",
            "total_s") if k in run}
        rep = run["replacement"]
        proc = next(r for r in run["logs"][1] if r["pid"] == rep["pid"])
        row.update({
            "kill_to_first_commit_s": rep["kill_to_first_commit_s"],
            "heal": {k: rep["heal"].get(k) for k in (
                "path", "wire", "streams", "bytes", "fetch_s", "h2d_s")},
            # cold: the interpreter, imports and model build come after
            # the kill; hot: only the gate's release does
            "replacement_imports_done_after_kill_s": round(
                proc["t_start"] - rep["t_kill"], 3),
            "replacement_gate_after_kill_s": round(
                proc["t_gate"] - rep["t_kill"], 3),
        })
        row["end"] = {"step": r0["step"], "bit_identical":
                      r0["digest"] == r1["digest"], "max_abs_drift": drift,
                      "drift_bound": bound}
        summary[name] = row
    hot = res["hot"]
    for key in ("takeover_s", "root_failover_s"):
        if not _finite(hot.get(key, float("nan"))):
            fail(f"control hot: no {key}")
    if hot["standby_root"].get("active") is not True:
        fail(f"control hot: the standby root is not active: "
             f"{hot['standby_root']}")
    summary["standbys"] = [
        {k: s.get(k) for k in ("group", "pid", "warm_s", "warm_launches",
                               "reserved_before_warm", "reserved_after_warm")}
        for s in hot["standbys"]]
    if not summary["standbys"]:
        fail("control hot: no spare finished its warm-up")
    if on_card:
        for s in hot["standbys"]:
            wl = s.get("warm_launches", {})
            if wl.get("q8_absmax", 0) < 1 or wl.get("q8_quantize", 0) < 1:
                fail(f"control hot: a spare's prewarm launched no pack: {s}")
        for name in ("q8_absmax", "q8_quantize", "cast_bf16"):
            if launches.get(name, 0) == 0:
                fail(f"control dense: {name} never launched")
    summary["context_bytes"] = res.get("context_bytes")
    summary["launches"] = launches
    return summary


def chaos_plan(seed: int = CHAOS_SEED):
    """The chaos flash plan: each of CHAOS_KINDS once, at attempted steps
    1..6 in a seeded order, on a seeded member, delays of 50-199 ms."""
    from torchft_tpu_torch.chaos import FaultEvent, FaultPlan, splitmix64

    h = splitmix64(seed)
    order = list(range(len(CHAOS_KINDS)))
    for i in range(len(order) - 1, 0, -1):  # seeded Fisher-Yates
        h = splitmix64(h ^ i)
        j = h % (i + 1)
        order[i], order[j] = order[j], order[i]
    events = []
    for step, k in enumerate(order, start=1):
        seam, kind = CHAOS_KINDS[k]
        h = splitmix64(h ^ step)
        member = h % 2
        h = splitmix64(h)
        param = 50 + h % 150 if kind == "delay" else 0
        events.append(FaultEvent(step, seam, kind, int(member), int(param)))
    return FaultPlan(seed=seed, events=tuple(events))


def chaos_worker(cfg: dict) -> None:
    """One flash-LM group under the seeded plan: CRC on the ring, a sync
    quorum, PipelinedDDP(q8) blocking steps; its native fault engine is
    armed once per attempted step (rules fire on the member they name).
    Group 0 serves its heals through a HealFaultProxy the parent arms
    (``arm_heal``: one truncated stream range). Every transaction, with
    the faults this process fired in it and, when it commits, the
    params' checksum, goes to ``progress_<group>.jsonl``."""
    import urllib.parse
    from datetime import timedelta

    import torchft_tpu_torch as tft
    from torchft_tpu_torch import _native, chaos
    from torchft_tpu_torch import checkpointing as ck
    from torchft_tpu_torch.models import transformer as tt
    from torchft_tpu_torch.ops import quantize_kernels as qk

    g, workdir = cfg["group"], cfg["workdir"]
    device = torch.device(cfg["device"])
    on_card = device.type == "cuda"
    plan = chaos.FaultPlan.from_json(cfg["plan"])
    model_cfg = tt.TransformerConfig(**cfg["lm"])
    model = tt.TransformerLM(model_cfg, seed=0, device=device)
    state = tft.FTTrainState(model.params(),
                             tft.AdamW(1e-3, weight_decay=1e-4))
    t_op = timedelta(seconds=CHAOS_OP_TIMEOUT_S)
    transport = proxy = None
    if g == 0:
        box: dict = {}

        class _Proxied(ck.CheckpointServer):
            def metadata(self) -> str:
                return box["proxy"].address() + "/checkpoint/"

        transport = _Proxied(timeout=timedelta(seconds=60), device=device)
        parts = urllib.parse.urlparse(transport.address())
        proxy = box["proxy"] = chaos.HealFaultProxy(
            f"{parts.scheme}://{parts.netloc}", only_paths=("/stream/",),
            max_faults=1)
    collectives = tft.HostCollectives(
        timeout=t_op, connect_timeout=timedelta(seconds=CONTROL_CONNECT_S))
    manager = tft.Manager(
        collectives=collectives, load_state_dict=state.load_state_dict,
        state_dict=state.state_dict, min_replica_size=1,
        use_async_quorum=False, rank=0, world_size=1, timeout=t_op,
        quorum_timeout=timedelta(seconds=60),
        connect_timeout=timedelta(seconds=30),
        lighthouse_addr=cfg["lighthouse"], replica_id=f"chaos{g}",
        device=device, checkpoint_transport=transport)
    ddp = tft.PipelinedDDP(manager, state, tt.make_grad_fn(model_cfg),
                           compress="q8", transport="plan", device_pack=True)
    injector = chaos.ChaosInjector(plan)
    prog = open(os.path.join(workdir, f"progress_{g}.jsonl"), "a")
    if proxy is not None:
        # armed by a thread of its own, not at the top of the step loop:
        # when the kill lands while this group waits in a quorum, the
        # restarted group's heal is served inside that same quorum call
        def arm() -> None:
            while not os.path.exists(os.path.join(workdir, "arm_heal")):
                time.sleep(0.02)
            proxy.mode = "truncate_body"

        threading.Thread(target=arm, daemon=True).start()

    def emit(row: dict) -> None:
        prog.write(json.dumps(row) + "\n")
        prog.flush()

    data = {"group": g, "lm": cfg["lm"], "batch": cfg["batch"],
            "seq": cfg["seq"]}
    qk.reset_launch_counts()
    armed_for, heals = -1, 0
    seen: dict = {}

    def fired_since() -> dict:
        """The faults this process fired since the last call."""
        fired = _native.fault_stats().get("fired", {})
        delta = {k: n - seen.get(k, 0) for k, n in fired.items()
                 if n > seen.get(k, 0)}
        seen.update(fired)
        return delta

    try:
        while True:
            attempted = manager.current_step()
            stop = _read_stop(workdir)
            if stop is not None and attempted >= stop:
                break
            if attempted != armed_for:
                # a discarded step retries at the same attempted step
                # without re-arming its one-shot rules
                injector.begin_step(attempted, member=g)
                armed_for = attempted
            t0 = time.time()
            committed, err = _guarded_step(
                ddp, manager, _tokens(data, attempted, device))
            row = _txn_row(manager, t0, committed, err)
            # the transaction's step: a sync-quorum heal moves a restarted
            # member's clock inside the step
            row.update({
                "attempted": attempted,
                "txn": row["step"] - 1 if committed else attempted,
                "crc": isinstance(err, _native.WireCorruption),
                "fired": fired_since()})
            if committed:  # the groups' params at every step both commit
                row["checksum"] = _checksum(state.params)
            fetch = getattr(manager.checkpoint_transport(),
                            "last_fetch_stats", None)
            n_heals = manager.metrics().snapshot()["counters"].get("heals", 0)
            if fetch and n_heals > heals:
                heals = n_heals
                row["heal"] = fetch
            emit(row)
        stats = injector.finish()
        if on_card:
            torch.cuda.synchronize(device)
        out = {"group": g, "pid": os.getpid(), "restart": cfg.get("restart",
                                                                  False),
               "digest": _digest(state.params), "step": manager.current_step(),
               "launches": dict(qk.launch_counts), "fault_stats": stats,
               "proxy_faults": proxy.faults_fired if proxy else None,
               "proxy_requests": len(proxy.requests) if proxy else None}
    finally:
        prog.close()
        manager.shutdown()
        collectives.shutdown()
        if proxy is not None:
            proxy.shutdown()
    with open(os.path.join(workdir, f"result_{g}_{os.getpid()}.json"),
              "w") as f:
        json.dump(out, f)


def phase_chaos_flash(workdir: str, device: str = "cuda", lm: dict = CHAOS_LM,
                      batch: int = BIG_BATCH, seq: int = BIG_SEQ) -> dict:
    """Two flash groups under the seeded plan with TORCHFT_WIRE_CRC=1,
    then a SIGKILL of group 1 at CHAOS_KILL_STEP and its restart, which
    heals through the donor's truncating proxy."""
    import torchft_tpu_torch as tft
    from torchft_tpu_torch.chaos import kill_process

    plan = chaos_plan()
    # two members per quorum: the groups take every attempted step in
    # lockstep (each arms that step's rules), and the survivor waits for
    # the restarted group rather than commit alone
    lighthouse = tft.Lighthouse(min_replicas=2, join_timeout_ms=10000,
                                quorum_tick_ms=50,
                                heartbeat_timeout_ms=CONTROL_LEASE_MS)
    base = {"lighthouse": lighthouse.address(), "workdir": workdir,
            "device": device, "lm": lm, "batch": batch, "seq": seq,
            "role": "chaos", "plan": plan.to_json(),
            "env": {"TORCHFT_WIRE_CRC": "1",
                    "TORCHFT_LEASE_TTL_MS": str(CONTROL_LEASE_MS)}}
    t0 = time.perf_counter()
    procs = []
    out = {"seed": plan.seed, "plan": plan.to_json()}
    try:
        procs = [_spawn({**base, "group": g}, workdir) for g in (0, 1)]

        def gone() -> bool:
            return any(p.poll() not in (None, 0) for p in procs)

        _wait_progress(workdir, lambda logs: any(
            r.get("committed") and r["step"] >= CHAOS_KILL_STEP
            for r in logs[1]), 900, "group 1 at the kill step", gone)
        open(os.path.join(workdir, "arm_heal"), "w").close()
        victim = procs[1]
        t_kill = time.time()
        kill_process(victim.pid)
        victim.wait(30)
        procs[1] = _spawn({**base, "group": 1, "restart": True}, workdir,
                          cold=True)
        first = _wait_progress(workdir, lambda logs: next(iter(
            [r for r in logs[1] if r.get("committed")
             and r["pid"] == procs[1].pid]), None), 300,
            "the restarted group's first commit",
            lambda: procs[0].poll() not in (None, 0)
            or procs[1].poll() not in (None, 0))
        out["kill_to_first_commit_s"] = first["t"] - t_kill
        last = max(r.get("step", 0) for g in (0, 1)
                   for r in _progress(workdir, g))
        _write_stop(workdir, last + CHAOS_TAIL_STEPS)
        _join([procs[0], procs[1]], time.monotonic() + 300, workdir)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        lighthouse.shutdown()
    out["total_s"] = time.perf_counter() - t0
    out["logs"] = {g: _progress(workdir, g) for g in (0, 1)}
    out["results"] = []
    for name in sorted(os.listdir(workdir)):
        if name.startswith("result_"):
            with open(os.path.join(workdir, name)) as f:
                out["results"].append(json.load(f))
    return out


def check_chaos_flash(res: dict, on_card: bool = True) -> dict:
    """The four invariants: epoch purity, survivors bit-identical, every
    corrupting fault detected and its step discarded, a clean commit
    after the last fault and after the restart."""
    plan = json.loads(res["plan"])
    logs = res["logs"]
    rows = {g: [r for r in logs[g] if "attempted" in r] for g in (0, 1)}
    commits = {g: {} for g in (0, 1)}
    for g in (0, 1):
        for r in rows[g]:
            if r["committed"]:
                commits[g][r["txn"]] = r
    # 1. epoch purity
    for g in (0, 1):
        steps = sorted(commits[g])
        for a, b in zip(steps, steps[1:]):
            if commits[g][a]["qid"] > commits[g][b]["qid"]:
                fail(f"chaos: group {g}'s quorum epoch went back between "
                     f"steps {a} and {b} ({res['plan']})")
    for step in set(commits[0]) & set(commits[1]):
        q0, q1 = commits[0][step]["qid"], commits[1][step]["qid"]
        if q0 != q1:
            near = any(commits[g].get(step - 1, {}).get("qid")
                       != commits[g].get(step + 1, {}).get("qid")
                       or step - 1 not in commits[g]
                       or step + 1 not in commits[g] for g in (0, 1))
            if not near:
                fail(f"chaos: step {step} committed under epochs {q0} and "
                     f"{q1} with no quorum change near it ({res['plan']})")
    # 2. survivors bit-identical: at every step both groups committed
    # (before the kill too, which a heal from the survivor would hide)
    # and at the end
    for step in sorted(set(commits[0]) & set(commits[1])):
        if commits[0][step]["checksum"] != commits[1][step]["checksum"]:
            fail(f"chaos: the groups' params differ after step {step} "
                 f"({res['plan']})")
    finals = [r for r in res["results"]]
    if sorted(r["group"] for r in finals) != [0, 1]:
        fail(f"chaos: final results of groups "
             f"{[r['group'] for r in finals]}")
    if len({r["digest"] for r in finals}) != 1 or len(
            {r["step"] for r in finals}) != 1:
        fail(f"chaos: the groups ended apart: "
             f"{[(r['step'], r['digest'][:12]) for r in finals]}")
    # 3. detection, per fault: the attempt in which the sender's
    # corrupting rule fired commits on neither member, and the receiver's
    # row of that attempt (same attempted step, same quorum) is its first
    # there and ends in WireCorruption
    fired: dict = {}
    faults = []
    for g in (0, 1):
        for r in rows[g]:
            for k, n in r["fired"].items():
                by = fired.setdefault(r["attempted"], {})
                by[k] = by.get(k, 0) + n
                if k.split(":")[1] not in CORRUPTING_KINDS:
                    continue
                mine = [x for x in rows[1 - g]
                        if (x["attempted"], x["qid"]) == (r["attempted"],
                                                          r["qid"])]
                fault = {"fault": k, "attempted": r["attempted"],
                         "qid": r["qid"], "sender": g,
                         "sender_committed": r["committed"],
                         "receiver_committed": any(x["committed"]
                                                   for x in mine),
                         "receiver_crc": bool(mine) and mine[0]["crc"],
                         "receiver_err": mine[0]["err"] if mine else None}
                faults.append(fault)
                if fault["sender_committed"] or fault["receiver_committed"]:
                    fail(f"chaos: a corrupting fault committed: {fault} "
                         f"({res['plan']})")
                if not fault["receiver_crc"]:
                    fail(f"chaos: a corrupting fault was not detected as "
                         f"WireCorruption: {fault} ({res['plan']})")
    injected = sum(n for by in fired.values() for n in by.values())
    if injected < len(plan["events"]) or len(fired) < len(plan["events"]):
        fail(f"chaos: {injected} faults fired in {len(fired)} steps of "
             f"{len(plan['events'])} planned: {fired}")
    planned = sum(e["kind"] in CORRUPTING_KINDS for e in plan["events"])
    if len(faults) != planned:
        fail(f"chaos: {len(faults)} corrupting faults fired of {planned} "
             f"planned: {faults}")
    discards = {g: {r["attempted"] for r in rows[g] if not r["committed"]}
                for g in (0, 1)}
    # 4. liveness: clean commits after the last fault and the restart
    last_fault = max(e["step"] for e in plan["events"])
    if not any(s > last_fault for g in (0, 1) for s in commits[g]):
        fail("chaos: no commit after the last fault")
    # recovery: from each discard to the member's next commit
    recover = []
    for g in (0, 1):
        pending = None
        for r in rows[g]:
            if not r["committed"] and pending is None:
                pending = r["t"]
            elif r["committed"] and pending is not None:
                recover.append(round(r["t"] - pending, 3))
                pending = None
    heals = [r["heal"] for g in (0, 1) for r in rows[g] if "heal" in r]
    restart_heal = heals[-1] if heals else None
    if not restart_heal or restart_heal.get("path") == "stream":
        fail(f"chaos: the truncated stream range did not fall back: "
             f"{restart_heal}")
    donor = next(r for r in finals if r["group"] == 0)
    if donor["proxy_faults"] != 1:
        fail(f"chaos: the heal proxy faulted {donor['proxy_faults']} times")
    launches: dict = {}
    for r in finals:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    if on_card:
        for name in ("q8_absmax", "q8_quantize", "flash_fwd", "flash_bwd"):
            if launches.get(name, 0) == 0:
                fail(f"chaos: {name} never launched")
    return {
        "seed": res["seed"], "plan": plan["events"],
        "faults_injected": injected,
        "faults_by_step": {str(w): by for w, by in sorted(fired.items())},
        "corrupting_faults": faults,
        "detected_wire_corruption": sum(f["receiver_crc"] for f in faults),
        "steps_both_committed_same_params": len(set(commits[0])
                                                & set(commits[1])),
        "steps_discarded": {g: sorted(discards[g]) for g in (0, 1)},
        "recover_s": recover,
        "kill_to_first_commit_s": round(res["kill_to_first_commit_s"], 3),
        "restart_heal": {k: restart_heal.get(k) for k in (
            "path", "wire", "streams", "bytes", "fetch_s", "h2d_s")},
        "end_step": finals[0]["step"], "total_s": round(res["total_s"], 1),
        "launches": launches,
    }


def policy_worker(cfg: dict) -> None:
    """One flash-LM group under PolicyEngine on a sync-quorum manager:
    ddp_plan (q8) against sharded diloco_q8 (windows of 4, outer
    SGD(0.7, momentum 0.9, Nesterov)), a decision every 4 attempted
    steps, the cost knobs of POLICY_KNOBS."""
    import torchft_tpu_torch as tft
    from torchft_tpu_torch import policy as tpol
    from torchft_tpu_torch.models import transformer as tt
    from torchft_tpu_torch.ops import quantize_kernels as qk

    g, workdir = cfg["group"], cfg["workdir"]
    device = torch.device(cfg["device"])
    on_card = device.type == "cuda"
    model_cfg = tt.TransformerConfig(**cfg["lm"])
    model = tt.TransformerLM(model_cfg, seed=0, device=device)
    state = tft.FTTrainState(model.params(),
                             tft.AdamW(1e-3, weight_decay=1e-4))
    box: dict = {}
    collectives = tft.HostCollectives()
    manager = tft.Manager(
        collectives=collectives,
        load_state_dict=lambda sd: box["p"].load_state_dict(sd),
        state_dict=lambda: box["p"].state_dict(), min_replica_size=2,
        use_async_quorum=False, rank=0, world_size=1,
        lighthouse_addr=cfg["lighthouse"], replica_id=f"policy{g}",
        device=device)
    cands = [tpol.StrategySpec("ddp_plan", "ddp", transport="plan",
                               wire="q8"),
             tpol.StrategySpec("diloco_q8_h4", "diloco",
                               sync_every=POLICY_SYNC_EVERY, wire="q8",
                               sharded=True)]
    policy = box["p"] = tpol.PolicyEngine(
        manager, state, tt.make_grad_fn(model_cfg),
        outer_tx=tft.SGD(0.7, momentum=0.9, nesterov=True),
        candidates=cands, decide_every=POLICY_DECIDE_EVERY,
        knobs=tpol.CostKnobs(**POLICY_KNOBS))
    decide = policy._decide_and_maybe_switch
    decide_s: list = []

    def timed_decide() -> None:
        t0 = time.perf_counter()
        decide()
        decide_s.append(time.perf_counter() - t0)

    policy._decide_and_maybe_switch = timed_decide
    data = {"group": g, "lm": cfg["lm"], "batch": cfg["batch"],
            "seq": cfg["seq"]}
    try:
        qk.reset_launch_counts()
        step_s, modes = [], []
        for i in range(POLICY_STEPS):
            t0 = time.perf_counter()
            policy.step(_tokens(data, i, device))
            if on_card:
                torch.cuda.current_stream().synchronize()
            step_s.append(time.perf_counter() - t0)
            modes.append(policy.strategy.name)
        policy.flush()
        if on_card:
            torch.cuda.synchronize(device)
        out = {"group": g, "decisions": policy.decisions,
               "decide_s": decide_s, "step_s": step_s, "modes": modes,
               "digest": _digest(state.params),
               "launches": dict(qk.launch_counts),
               "step": manager.current_step()}
        if on_card:
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                device)
    finally:
        manager.shutdown()
        collectives.shutdown()
    with open(os.path.join(workdir, f"result_{g}.json"), "w") as f:
        json.dump(out, f)


def phase_policy_flash(workdir: str, device: str = "cuda", lm: dict = CHAOS_LM,
                       batch: int = BIG_BATCH, seq: int = BIG_SEQ) -> dict:
    return _run_groups(workdir, {"device": device, "role": "policy",
                                 "lm": lm, "batch": batch, "seq": seq},
                       [{}, {}])


def check_policy_flash(res: dict, on_card: bool = True) -> dict:
    a, b = res["results"]
    if a["decisions"] != b["decisions"]:
        fail(f"policy: the members' decisions differ:\n{a['decisions']}\n"
             f"{b['decisions']}")
    switches = [d for d in a["decisions"] if d["switched"]]
    if not switches or not all(d["committed"] for d in a["decisions"]):
        fail(f"policy: no committed switch: {a['decisions']}")
    if a["digest"] != b["digest"] or a["step"] != b["step"]:
        fail("policy: the members' params differ at the end")
    launches: dict = {}
    for r in (a, b):
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    if on_card:
        for name in ("q8_absmax", "q8_quantize", "q8_dequantize",
                     "flash_fwd", "flash_bwd"):
            if launches.get(name, 0) == 0:
                fail(f"policy: {name} never launched")
    return {
        "decisions": [{k: d[k] for k in ("epoch", "tick", "from", "to",
                                         "committed", "switched", "costs")}
                      for d in a["decisions"]],
        "signals": [d["signals"] for d in a["decisions"]],
        "switch_ticks": [d["tick"] for d in switches],
        "decide_s": [[round(x, 4) for x in r["decide_s"]] for r in (a, b)],
        "step_ms": [[round(1e3 * x, 1) for x in r["step_s"]] for r in (a, b)],
        "modes": a["modes"], "launches": launches, "step": a["step"],
        "knobs": POLICY_KNOBS,
        "max_memory_allocated_gb": [round(r.get("max_memory_allocated", 0)
                                          / 2**30, 2) for r in (a, b)],
    }


def _keep_logs(workdir: str, name: str) -> None:
    """Copies a phase's progress logs and results (not its params) to
    ``$CHIP_SMOKE_LOGDIR/<name>/`` when that variable is set."""
    import shutil

    dest_root = os.environ.get("CHIP_SMOKE_LOGDIR")
    if not dest_root:
        return
    for root, _, files in os.walk(workdir):
        for f in files:
            if f.endswith((".jsonl", ".json", ".log")):
                rel = os.path.relpath(os.path.join(root, f), workdir)
                dest = os.path.join(dest_root, name, rel)
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                shutil.copy(os.path.join(root, f), dest)


def control_phases(by_phase: dict, harness: bool = False) -> None:
    """The control dense, chaos flash and policy flash phases: each runs,
    is checked and logged, and puts its launch counts into ``by_phase``;
    ``harness``: the chaos harness phase runs beside the last two."""
    _phase("control dense")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_control_") as workdir:
        try:
            cres = phase_control_dense(workdir)
            csum = check_control_dense(cres)
        finally:
            _keep_logs(workdir, "control_dense")
    by_phase["control dense"] = csum["launches"]
    log(f"  control dense {cres['total_s']:.1f} s (two dense groups launched "
        f"with hot spares, two regions and a WAL'd root + standby root, "
        f"then again cold): hot {json.dumps(csum['hot'])}; cold "
        f"{json.dumps(csum['cold'])}")
    log(f"  control dense spares (prewarm + warm on the card before the "
        f"gate): {json.dumps(csum['standbys'])}; a CUDA context takes "
        f"{csum['context_bytes']} B of the card per process")
    if harness:
        harness_phases(by_phase, beside=lambda: _chaos_policy_phases(by_phase))
    else:
        _chaos_policy_phases(by_phase)


def _chaos_policy_phases(by_phase: dict) -> None:
    _phase("chaos flash")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_") as workdir:
        try:
            xres = phase_chaos_flash(workdir)
            xsum = check_chaos_flash(xres)
        finally:
            _keep_logs(workdir, "chaos_flash")
    by_phase["chaos flash"] = xsum.pop("launches")
    log(f"  chaos flash: seed {xsum['seed']} plan {json.dumps(xsum['plan'])}")
    log(f"  chaos flash: {json.dumps(xsum)}")
    _phase("policy flash")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_policy_") as workdir:
        try:
            pres = phase_policy_flash(workdir)
            psum = check_policy_flash(pres)
        finally:
            _keep_logs(workdir, "policy_flash")
    by_phase["policy flash"] = psum["launches"]
    log(f"  policy flash {pres['total_s']:.1f} s: {json.dumps(psum)}")


# -- the chaos-invariant harness ---------------------------------------------------

HARNESS = os.path.join(REPO, "scripts", "chaos_run_torch.py")
# the q8 plan schedule: member 1's send bit-flipped at attempted step 1,
# member 0's dropped at step 2 (the port's CPU gate's plan), on the main
# path's wire (the q8ef plan, K1a/K1b on the card)
HARNESS_Q8_PLAN = {"seed": 1031, "events": [
    {"step": 1, "seam": "ring_send", "kind": "bit_flip", "member": 1,
     "param": 0},
    {"step": 2, "seam": "ring_send", "kind": "drop", "member": 0, "param": 0}]}
HARNESS_TIMEOUT_S = 300


def _harness_json(text: str, first_key: str) -> dict:
    """The record a harness run printed: the JSON object whose first key
    is ``first_key`` (the dryrun's one line, or a replay's indented
    object, which runs to the end of stdout)."""
    start = text.find("{\n  " + json.dumps(first_key))
    if start < 0:
        start = text.find("{" + json.dumps(first_key))
    if start < 0:
        fail(f"the chaos harness printed no record:\n{text[-2000:]}")
    obj, _ = json.JSONDecoder().raw_decode(text[start:])
    return obj


def _harness_start(workdir: str, device: str = "cuda",
                   tree: str = "dense") -> dict:
    """Starts ``scripts/chaos_run_torch.py --dryrun`` on
    ``tree`` and, beside it, one plan schedule on the q8 wire: two
    processes at once (each arms only its own fault engine). A thread a
    process notes when it ends."""
    runs = {
        "dryrun": ["--dryrun", "--tree", tree, "--device", device],
        "q8 plan": ["--config", "plan", "--seed", "1031", "--tree", tree,
                    "--wire", "q8", "--device", device,
                    "--plan", json.dumps(HARNESS_Q8_PLAN)],
    }
    run: dict = {"t0": time.perf_counter(), "procs": {}, "ended": {}}
    for name, argv in runs.items():
        tag = name.replace(" ", "_")
        paths = (os.path.join(workdir, f"harness_{tag}.out"),
                 os.path.join(workdir, f"harness_{tag}.err"))
        proc = _popen_worker(argv, paths[0], HARNESS, paths[1])

        def watch(name=name, proc=proc) -> None:
            try:
                proc.wait(timeout=HARNESS_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            run["ended"][name] = time.perf_counter()

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        run["procs"][name] = (proc, paths, watcher)
    return run


def _harness_finish(run: dict) -> dict:
    """Waits for the harness's processes; returns their records and the
    seconds from the start to each one's end."""
    out: dict = {"seconds": {}}
    for name, (proc, (log_path, err_path), watcher) in run["procs"].items():
        watcher.join()
        out["seconds"][name] = round(run["ended"][name] - run["t0"], 1)
        with open(log_path) as f:
            text = f.read()
        if proc.returncode != 0:
            with open(err_path) as f:
                err = f.read()
            fail(f"the chaos harness's {name} exited {proc.returncode}:\n"
                 f"{text[-2500:]}\n{err[-2500:]}")
        out[name] = _harness_json(text, "dryrun" if name == "dryrun"
                                  else "config")
    out["total_s"] = max(out["seconds"].values())
    return out


def phase_chaos_harness(workdir: str, device: str = "cuda",
                        tree: str = "dense") -> dict:
    """The harness's two processes, started together and waited for."""
    return _harness_finish(_harness_start(workdir, device, tree))


def check_chaos_harness(res: dict, on_card: bool = True) -> dict:
    """The dryrun's records (a detected corruption, a SIGSTOP stall, a
    root restart that replayed its WAL, a sharded re-partition, a
    fleet-loss restore bit-identical to the pre-kill digest, a
    serving-churn record) and the four invariants on every schedule."""
    dry, q8 = res["dryrun"], res["q8 plan"]
    for key in ("detected_corruption_records", "sigstop_stall_records",
                "root_restart_records", "sharded_reshard_records",
                "fleet_loss_records", "serving_churn_records"):
        if dry.get(key, 0) < 1:
            fail(f"chaos harness dryrun: no {key.replace('_', ' ')}")
    records = dry["records"] + [q8]
    for rec in records:
        name = f"{rec['config']} seed {rec.get('seed')}"
        if rec.get("silent_commits", 0) != 0:
            fail(f"chaos harness {name}: silent commits")
        for key in ("epoch_purity_ok", "bit_identity_ok", "liveness_ok"):
            if key in rec and rec[key] is not True:
                fail(f"chaos harness {name}: {key} is not true")
        if on_card and rec.get("device", "cuda").split(":")[0] != "cuda":
            fail(f"chaos harness {name} ran on {rec['device']}")
    if sum(r.get("crc_detections", 0) for r in records) < 1:
        fail("chaos harness: no CRC detection")
    outage = [r for r in dry["records"] if r["config"] == "root_outage"]
    if not any(r["root_restarts"] >= 1 and r["wal_replays_seen"] >= 1
               for r in outage):
        fail("chaos harness: no root restart replayed its WAL")
    fleet = [r for r in dry["records"] if r["config"] == "fleet_loss"]
    if not any(r["restored_digest"] == r["pre_kill_digest"] for r in fleet):
        fail("chaos harness: the fleet-loss restore differs from the "
             "pre-kill digest")
    launches = dict(dry["launch_counts"])
    for k, v in q8.get("launches", {}).items():
        launches[k] = launches.get(k, 0) + v
    rows = [{
        "schedule": f"{r['config']} seed {r.get('seed')}"
        + (f" wire {r['wire']}" if r.get("wire") else ""),
        "wall_s": r.get("wall_s"),
        "faults_fired": r.get("faults_fired", r.get("python_faults")),
        "crc_detections": r.get("crc_detections"),
        "commits_per_member": r.get("commits_per_member"),
    } for r in records]
    return {"launches": launches, "rows": rows, "outage": outage,
            "fleet": fleet, "iso_probes": dry["iso_probes"]}


def harness_phases(by_phase: dict, beside=None) -> None:
    """The chaos-invariant harness phase: runs, is checked and logged,
    and puts its launch counts into ``by_phase``. With ``beside`` (a
    function running other phases), its processes run while that does
    (they load the host, not the card: the members' trees are 93 MB
    each), and its own seconds go to the phase_s line apart."""
    if beside is None:
        _phase("chaos harness")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_harness_") as workdir:
        run = _harness_start(workdir)
        try:
            if beside is not None:
                beside()
            res = _harness_finish(run)
            summ = check_chaos_harness(res)
        finally:
            for proc, _, _ in run["procs"].values():
                if proc.poll() is None:  # a phase beside it failed
                    # SIGINT: the harness's finally blocks stop the roots,
                    # publisher and fleet members it started
                    proc.send_signal(signal.SIGINT)
                    try:
                        proc.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()
            _keep_logs(workdir, "chaos_harness")
    if beside is not None:
        PHASES_BESIDE["chaos harness"] = round(res["total_s"], 1)
    by_phase["chaos harness"] = summ["launches"]
    log(f"  chaos harness {res['total_s']:.1f} s"
        + (" (beside the chaos flash and policy flash phases)"
           if beside is not None else "")
        + f": scripts/chaos_run_torch.py --dryrun --tree dense "
        f"and, beside it, a q8 plan schedule, members' trees on the card; "
        f"each process done at {json.dumps(res['seconds'])} s; "
        f"launches {json.dumps(summ['launches'])}")
    for row in summ["rows"]:
        log(f"  chaos harness schedule {json.dumps(row)}")
    for r in summ["outage"]:
        log(f"  chaos harness root outage: takeover_s {r['takeover_s']}, "
            f"kill_to_next_commit_s {r['kill_to_next_commit_s']}, root "
            f"epochs {r['root_epochs_seen']}, restarts {r['root_restarts']}, "
            f"WAL replays seen {r['wal_replays_seen']}")
    for r in summ["fleet"]:
        log(f"  chaos harness fleet loss: resumed step {r['resumed_step']} "
            f"(torn record step {r['torn_record_step']}), kill to restored "
            f"commit {r['kill_to_restored_commit_s']} s, restored digest "
            f"equals the pre-kill digest")
    log(f"  chaos harness iso probes: {json.dumps(summ['iso_probes'])}")


# -- the quickstart trainer -------------------------------------------------------

QUICKSTART = os.path.join(REPO, "examples", "train_ddp_torch.py")
# The lm fleet: two groups under the launcher with a hot spare each, the
# CLI lighthouse (verify_e2e.sh's short join, tick and heartbeat), a
# durable snapshot every QS_CKPT_EVERY committed steps and the bf16 heal
# wire; group 1's primary is SIGKILLed once its log passes QS_KILL_STEP.
# QS_STEPS leaves the survivor, which trains on alone meanwhile, room to
# be met by the promoted spare well before the end (it moved 3 steps
# while the spare took over, at ~33 ms a step: NVIDIA H100 80GB HBM3,
# 700.00 W).
QS_STEPS = 400
QS_CKPT_EVERY = 100
QS_KILL_STEP = 100
QS_SIDE_STEPS = 60     # mlp, cnn and moe: one-group fleets beside it
QS_SIDE_MODELS = ("mlp", "cnn", "moe")
QS_TIMEOUT_S = 420
# verify_e2e.sh's short join, tick and heartbeat: the CLI lighthouse's
# flags and the side fleets' in-process lighthouses
QS_LIGHTHOUSE = {"min_replicas": 1, "join_timeout_ms": 2000,
                 "quorum_tick_ms": 50, "heartbeat_timeout_ms": 1000}
# runs a trainer as a user would and records what the checks read
# (``python QS_RECORDER OUTDIR SCRIPT``; see its docstring)
QS_RECORDER = os.path.join(REPO, "scripts", "train_record_torch.py")


def _qs_env(device: str, **knobs) -> dict:
    """The trainer's environment: the card by default (the trainer's
    own), ``DEVICE=cpu`` and one intra-op thread for a CPU rehearsal."""
    env = {**os.environ, **{k: str(v) for k, v in knobs.items()}}
    if device == "cpu":
        env.update(DEVICE="cpu", OMP_NUM_THREADS="1")
    return env


def _qs_records(outdir: str, kind: str) -> list:
    rows = []
    for name in sorted(os.listdir(outdir)):
        if name.startswith(kind + "_") and name.endswith(".json"):
            with open(os.path.join(outdir, name)) as f:
                rows.append(json.load(f))
    return rows


def _qs_trainer(outdir: str, log_path: str, env: dict) -> subprocess.Popen:
    """One trainer process, started cold: the first step of a fresh
    process is one of the things this phase measures."""
    os.makedirs(outdir, exist_ok=True)
    return subprocess.Popen(
        [sys.executable, QS_RECORDER, outdir, QUICKSTART],
        cwd=REPO, env=env, stdout=open(log_path, "w"),
        stderr=subprocess.STDOUT)


def _qs_wait_http(addr: str, proc: subprocess.Popen, timeout_s: float) -> str:
    import urllib.request

    deadline = time.monotonic() + timeout_s
    while True:
        try:
            with urllib.request.urlopen(addr + "/", timeout=2) as r:
                return r.read().decode("utf-8", "replace")
        except OSError:
            if proc.poll() is not None:
                fail(f"the lighthouse CLI exited {proc.returncode}")
            if time.monotonic() > deadline:
                fail(f"the lighthouse CLI did not answer at {addr}")
            time.sleep(0.2)


def _qs_killer(run: dict, kill_step: int) -> None:
    """Waits for group 1's log line past ``kill_step``, then SIGKILLs
    group 1's primary (the launcher promotes its spare)."""
    pat = re.compile(r"\[group 1\] step=(\d+) ")
    deadline = time.monotonic() + QS_TIMEOUT_S
    while time.monotonic() < deadline and run["launcher"].poll() is None:
        with open(run["launcher_log"]) as f:
            steps = [int(s) for s in pat.findall(f.read())]
        if steps and max(steps) >= kill_step:
            primary = [r for r in _qs_records(run["lm_dir"], "start")
                       if r["group"] == 1 and not r["standby"]]
            if len(primary) != 1:
                run["kill_error"] = f"group 1 primaries: {primary}"
                return
            run["t_kill"] = time.time()
            run["killed_pid"] = primary[0]["pid"]
            run["kill_seen_step"] = max(steps)
            os.kill(primary[0]["pid"], signal.SIGKILL)
            return
        time.sleep(0.05)
    run["kill_error"] = f"group 1 never logged step {kill_step}"


def _quickstart_start(workdir: str, device: str = "cuda",
                      steps: int = QS_STEPS, every: int = QS_CKPT_EVERY,
                      kill_step: int = QS_KILL_STEP,
                      side_steps: int = QS_SIDE_STEPS) -> dict:
    """Starts the lighthouse CLI, reads its dashboard back, then the lm
    fleet under the launcher (two groups, a hot spare each) and, at the
    same time, the mlp, cnn and moe one-group fleets, each on an
    in-process lighthouse of this process, and the durable restart's
    process, parked; a thread kills group 1's primary mid-run."""
    from torchft_tpu_torch import _native
    from torchft_tpu_torch.chaos import free_port
    from torchft_tpu_torch.lighthouse import fetch_status

    run: dict = {"t0": time.perf_counter(), "device": device, "steps": steps,
                 "every": every, "side_steps": side_steps,
                 "lm_dir": os.path.join(workdir, "lm"),
                 "ckpt_dir": os.path.join(workdir, "ckpt"),
                 "launcher_log": os.path.join(workdir, "launcher.log"),
                 "sides": {}, "side_lighthouses": []}
    os.makedirs(run["lm_dir"])
    port = free_port()
    addr = f"http://localhost:{port}"
    run["lighthouse_addr"] = addr
    run["lighthouse"] = subprocess.Popen(
        [sys.executable, "-m", "torchft_tpu_torch.lighthouse", "--bind",
         f"[::]:{port}",
         *(a for k, v in QS_LIGHTHOUSE.items() for a in (f"--{k}", str(v)))],
        cwd=REPO,
        stdout=open(os.path.join(workdir, "lighthouse.log"), "w"),
        stderr=subprocess.STDOUT)
    try:
        page = _qs_wait_http(addr, run["lighthouse"], 120)
        if "torchft" not in page.lower():
            fail(f"the lighthouse's dashboard reads {page[:200]!r}")
        status = fetch_status(addr)
        run["dashboard"] = {"page_bytes": len(page),
                            "status_keys": sorted(status),
                            "role": status.get("role")}
        run["t_fleet"] = time.time()
        run["launcher"] = subprocess.Popen(
            [sys.executable, "-m", "torchft_tpu_torch.launcher",
             "--num-replica-groups", "2", "--hot-spare", "--lighthouse", addr,
             "--", sys.executable, QS_RECORDER, run["lm_dir"], QUICKSTART],
            cwd=REPO, env=_qs_env(device, MODEL="lm", NUM_STEPS=steps,
                                  CKPT_DIR=run["ckpt_dir"], CKPT_EVERY=every,
                                  TORCHFT_HEAL_WIRE="bf16"),
            stdout=open(run["launcher_log"], "w"), stderr=subprocess.STDOUT)
        for model in QS_SIDE_MODELS:
            lh = _native.Lighthouse(bind="[::]:0", **QS_LIGHTHOUSE)
            run["side_lighthouses"].append(lh)
            env = _qs_env(device, MODEL=model, DATA="synthetic",
                          NUM_STEPS=side_steps, NUM_REPLICA_GROUPS=1,
                          REPLICA_GROUP_ID=0, TORCHFT_LIGHTHOUSE=lh.address())
            run["sides"][model] = (
                time.time(), _qs_trainer(os.path.join(workdir, model),
                                         os.path.join(workdir, f"{model}.log"),
                                         env))
        # the durable restart's process, started now and parked at the
        # trainer's standby gate until the fleet has ended (the launcher's
        # hot-spare path): its start overlaps the fleet's run
        run["restart_dir"] = os.path.join(workdir, "restart")
        run["restart_log"] = os.path.join(workdir, "restart.log")
        run["restart_go"] = os.path.join(workdir, "restart_go")
        run["restart"] = _qs_trainer(run["restart_dir"], run["restart_log"],
                                     _qs_env(device, MODEL="lm",
                                             NUM_STEPS=steps + 2,
                                             CKPT_DIR=run["ckpt_dir"],
                                             CKPT_EVERY=every,
                                             REPLICA_GROUP_ID=0,
                                             NUM_REPLICA_GROUPS=2,
                                             TORCHFT_LIGHTHOUSE=addr,
                                             TORCHFT_STANDBY_FILE=run["restart_go"]))
        run["killer"] = threading.Thread(target=_qs_killer,
                                         args=(run, kill_step), daemon=True)
        run["killer"].start()
    except BaseException:
        _qs_stop(run)
        raise
    return run


def _qs_stop(run: dict) -> None:
    """Stops whatever of the phase still runs: the launcher (SIGINT: it
    terminates its groups and kills its parked spares; if it does not
    exit, it is killed, and so is every trainer that wrote a start
    record), the side fleets, the restart and the lighthouses."""
    launcher = run.get("launcher")
    if launcher is not None and launcher.poll() is None:
        launcher.send_signal(signal.SIGINT)
        try:
            launcher.wait(timeout=30)
        except subprocess.TimeoutExpired:
            launcher.kill()
            launcher.wait()
            for r in _qs_records(run["lm_dir"], "start"):
                try:
                    os.kill(r["pid"], signal.SIGKILL)
                except OSError:
                    pass  # gone already
    procs = [p for _, p in run.get("sides", {}).values()]
    if run.get("restart") is not None:
        procs.append(run["restart"])
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    if run.get("lighthouse") is not None and run["lighthouse"].poll() is None:
        run["lighthouse"].terminate()
        try:
            run["lighthouse"].wait(timeout=15)
        except subprocess.TimeoutExpired:
            run["lighthouse"].kill()
            run["lighthouse"].wait()
    for lh in run.get("side_lighthouses", []):
        lh.shutdown()
    run["side_lighthouses"] = []


def _qs_states(outdir: str, kind: str) -> list:
    """The states the recorder saved in ``outdir``: ``served`` (each a
    process handed a healing peer) or ``healed`` (each a heal left)."""
    return [{**torch.load(os.path.join(outdir, name)),
             "pid": int(name.split("_")[1])}
            for name in sorted(os.listdir(outdir))
            if name.startswith(kind + "_") and name.endswith(".pt")]


def _qs_handover(served: list, healed: dict) -> dict:
    """A heal against the state a peer served at its step: every leaf the
    bf16 wire ships raw (the params) bit for bit, each leaf it narrows
    (the f32 opt_state moments) equal to the served one rounded to bf16
    (round to nearest even) and widened back. Returns the served state."""
    peers = [x for x in served if x["step"] == healed["step"]
             and x["pid"] != healed["pid"]]
    if not peers:
        fail(f"quickstart: pid {healed['pid']} healed at step "
             f"{healed['step']}, a state no peer served")
    donor = peers[-1]
    if (donor["paths"], donor["narrow"]) != (healed["paths"], healed["narrow"]):
        fail(f"quickstart: the heal at step {healed['step']} has another "
             "tree than the state served")
    for path, a, b, narrow in zip(donor["paths"], donor["leaves"],
                                  healed["leaves"], donor["narrow"]):
        want = a.to(torch.bfloat16).float() if narrow else a
        if not _bits_equal(b, want):
            fail(f"quickstart: the heal at step {healed['step']} left {path} "
                 f"other than the served state{' rounded to bf16' * narrow}")
    return donor


def _qs_tail(path: str, n: int = 3000) -> str:
    with open(path) as f:
        return f.read()[-n:]


def _quickstart_finish(run: dict, workdir: str) -> dict:
    """Waits for the fleets, releases the parked restart of group 0 on
    the durable directory, and returns every process's record."""
    try:
        deadline = time.monotonic() + QS_TIMEOUT_S
        try:
            rc = run["launcher"].wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            fail(f"the quickstart launcher ran past {QS_TIMEOUT_S} s:\n"
                 f"{_qs_tail(run['launcher_log'])}")
        run["killer"].join()
        if "kill_error" in run:
            fail(f"quickstart: {run['kill_error']}")
        if rc != 0:
            fail(f"the quickstart launcher exited {rc}:\n"
                 f"{_qs_tail(run['launcher_log'])}")
        run["t_fleet_end"] = time.perf_counter()
        # group 0 alone on the same durable directory, two steps past
        restart_dir, restart_log = run["restart_dir"], run["restart_log"]
        open(run["restart_go"], "w").close()  # releases its standby gate
        sides = {}
        for model, (t_spawn, proc) in run["sides"].items():
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                fail(f"the {model} quickstart ran past {QS_TIMEOUT_S} s")
            log_path = os.path.join(workdir, f"{model}.log")
            if proc.returncode != 0:
                fail(f"the {model} quickstart exited {proc.returncode}:\n"
                     f"{_qs_tail(log_path)}")
            (rec,) = _qs_records(os.path.join(workdir, model), "end")
            sides[model] = {**rec, "t_spawn": t_spawn}
        try:
            run["restart"].wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            fail("the durable restart ran past the phase's time")
        if run["restart"].returncode != 0:
            fail(f"the durable restart exited {run['restart'].returncode}:\n"
                 f"{_qs_tail(restart_log)}")
        with open(restart_log) as f:
            restart_text = f.read()
        (restart,) = _qs_records(restart_dir, "end")
        with open(run["launcher_log"]) as f:
            launcher_text = f.read()
    finally:
        _qs_stop(run)
    return {
        "steps": run["steps"], "every": run["every"],
        "side_steps": run["side_steps"], "dashboard": run["dashboard"],
        "t_kill": run["t_kill"], "t_fleet": run["t_fleet"],
        "killed_pid": run["killed_pid"],
        "kill_seen_step": run["kill_seen_step"],
        "lm": _qs_records(run["lm_dir"], "end"),
        "lm_starts": _qs_records(run["lm_dir"], "start"),
        "served": _qs_states(run["lm_dir"], "served"),
        "healed": _qs_states(run["lm_dir"], "healed"),
        "sides": sides, "restart": restart, "restart_log": restart_text,
        "launcher_log": launcher_text,
        "fleet_s": run["t_fleet_end"] - run["t0"],
        "total_s": time.perf_counter() - run["t0"],
    }


def phase_quickstart(workdir: str, device: str = "cuda", **sizes) -> dict:
    """The quickstart: the lighthouse CLI, the launcher with hot spares
    over ``examples/train_ddp_torch.py`` (lm) with a SIGKILL, the mlp,
    cnn and moe fleets beside it, then a durable restart."""
    return _quickstart_finish(_quickstart_start(workdir, device, **sizes),
                              workdir)


def _qs_step_p50_ms(rec: dict) -> float:
    t = [c[1] for c in rec["commits"]]
    return round(1e3 * _median([b - a for a, b in zip(t, t[1:])]), 3)


def _qs_first_step(rec: dict, t_spawn: "float | None" = None) -> dict:
    """A fresh process's way to its first commit, in seconds."""
    out = {"imports_model_warmup_s": rec["t_manager"] - rec["t_start"],
           "manager_to_first_commit_s": rec["commits"][0][1] - rec["t_manager"],
           "start_to_first_commit_s": rec["commits"][0][1] - rec["t_start"]}
    if t_spawn is not None:
        out["interpreter_s"] = rec["t_start"] - t_spawn
        out["spawn_to_first_commit_s"] = rec["commits"][0][1] - t_spawn
    return {k: round(v, 3) for k, v in out.items()}


def check_quickstart(res: dict, on_card: bool = True) -> dict:
    """Both lm groups at NUM_STEPS with equal batches committed; group
    1's spare parked until the kill, promoted, healed from group 0 on the
    stream path and the bf16 wire; every heal left the state its peer
    served (params bit for bit, moments rounded to bf16); K3 against its
    plain version, bit for bit, on the opt_state leaves that heal staged;
    the final params within the drift that wire's rounding allows; the
    durable restart at the last snapshot; mlp, cnn and moe at their
    steps; K3 launched on the card."""
    from torchft_tpu_torch.ops import quantize_kernels as qk
    from torchft_tpu_torch.ops._lib import _kernels

    steps, every = res["steps"], res["every"]
    by_role = {}
    for rec in res["lm"]:
        if rec.get("rc") != 0:
            fail(f"quickstart lm pid {rec['pid']}: {rec.get('error')}")
        by_role[(rec["group"], rec["standby"])] = rec
    if set(by_role) != {(0, False), (1, True)}:
        fail(f"quickstart: ended trainers {sorted(by_role)}, want group 0's "
             "primary and group 1's promoted spare")
    g0, spare = by_role[(0, False)], by_role[(1, True)]
    if not any(r["group"] == 1 and not r["standby"]
               and r["pid"] == res["killed_pid"] for r in res["lm_starts"]):
        fail("quickstart: the killed process was not group 1's primary")
    if "promoted standby pid %d" % spare["pid"] not in res["launcher_log"]:
        fail("quickstart: the launcher never promoted group 1's spare")
    if spare["t_manager"] < res["t_kill"]:
        fail("quickstart: group 1's spare left its gate before the kill")
    for rec in (g0, spare):
        if rec["step"] != steps:
            fail(f"quickstart group {rec['group']} ended at step "
                 f"{rec['step']}, not {steps}")
    if g0["batches_committed"] != spare["batches_committed"]:
        fail(f"quickstart: batches committed {g0['batches_committed']} "
             f"(group 0) != {spare['batches_committed']} (group 1)")
    heal = spare["heal"] or {}
    if heal.get("path") != "stream" or heal.get("wire") != "bf16":
        fail(f"quickstart: the promoted spare's heal {heal}")
    if spare["counters"].get("heals", 0) < 1:
        fail("quickstart: the promoted spare never healed")
    heal_step = spare["commits"][0][0]
    healed = {x["pid"]: x for x in res["healed"]}
    if spare["pid"] not in healed:
        fail("quickstart: no state recorded from the promoted spare's heal")
    donor = None
    for x in res["healed"]:  # group 1's initial sync too
        served = _qs_handover(res["served"], x)
        if x["pid"] == spare["pid"]:
            donor = served
    # K3 over the group the spare's heal staged (the durable pack's
    # group is the same leaves), against its plain version
    moments = [l.to("cuda" if on_card else "cpu")
               for l, n in zip(donor["leaves"], donor["narrow"]) if n]
    _k3_k2_group_case(qk, f"quickstart heal staging ({len(moments)} "
                      f"opt_state leaves)", moments, 0,
                      _kernels.lib().tft_seg_capacity() if on_card else 0)
    if g0["lr"] != spare["lr"]:
        fail(f"quickstart: learning rates {g0['lr']} and {spare['lr']}")
    drift = _param_drift(g0["params"], spare["params"])
    bound = _bf16_heal_drift_bound(steps - heal_step + 1, lr=g0["lr"])
    if not drift <= bound:
        fail(f"quickstart: the groups' params part by {drift}, past the "
             f"bf16 heal's bound {bound}")
    snapshot = steps // every * every
    if every * 2 > steps:
        fail("quickstart: CKPT_EVERY fires fewer than twice")
    if f"restored durable ckpt at step {snapshot}" not in res["restart_log"]:
        fail(f"quickstart: the restart did not restore step {snapshot}")
    if res["restart"]["step"] != steps + 2:
        fail(f"quickstart: the restart ended at {res['restart']['step']}")
    for model, rec in res["sides"].items():
        if rec["step"] != res["side_steps"] or rec["batches_committed"] != rec["step"]:
            fail(f"quickstart {model}: step {rec['step']}, batches "
                 f"{rec['batches_committed']}")
    launches: dict = {}
    for rec in [*res["lm"], res["restart"], *res["sides"].values()]:
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
    if on_card and launches.get("cast_bf16", 0) == 0:
        fail("quickstart: K3 never launched in the fleet")
    return {
        "launches": launches,
        "kill_to_first_commit_s": round(spare["commits"][0][1] - res["t_kill"], 3),
        "kill_to_promoted_s": round(spare["t_promoted"] - res["t_kill"], 3),
        "kill_to_manager_s": round(spare["t_manager"] - res["t_kill"], 3),
        "handover": {"heals": len(res["healed"]), "step": donor["step"],
                     "leaves": len(donor["leaves"]),
                     "moments": len(moments)},
        "heal": {k: heal.get(k) for k in ("path", "wire", "streams", "bytes",
                                          "fetch_s", "h2d_s")},
        "heal_step": heal_step, "kill_seen_step": res["kill_seen_step"],
        "batches_committed": g0["batches_committed"],
        "param_drift": drift, "drift_bound": bound,
        "restored_step": snapshot,
        "step_ms_p50": {"lm": _qs_step_p50_ms(g0),
                        **{m: _qs_step_p50_ms(r) for m, r in res["sides"].items()}},
        "timers_p50_ms": {"lm group 0": g0["timers_p50_ms"],
                          **{m: r["timers_p50_ms"]
                             for m, r in res["sides"].items()}},
        "first_step": {"lm group 0": _qs_first_step(g0),
                       **{m: _qs_first_step(r, r["t_spawn"])
                          for m, r in res["sides"].items()}},
        "dashboard": res["dashboard"],
        "fleet_s": round(res["fleet_s"], 1),
    }


def quickstart_phases(by_phase: dict, beside=None) -> None:
    """The quickstart phase: runs, is checked and logged, and puts its
    launch counts into ``by_phase``. With ``beside`` (a function running
    other phases), its processes run while that does, and its own
    seconds go to the phase_s line apart."""
    if beside is None:
        _phase("quickstart")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_quickstart_") as workdir:
        try:
            run = _quickstart_start(workdir)
            if beside is not None:
                try:
                    beside()
                except BaseException:
                    _qs_stop(run)
                    raise
            res = _quickstart_finish(run, workdir)
            summ = check_quickstart(res)
        finally:
            _keep_logs(workdir, "quickstart")
    if beside is not None:
        PHASES_BESIDE["quickstart"] = round(res["total_s"], 1)
    by_phase["quickstart"] = summ["launches"]
    log(f"  quickstart {res['total_s']:.1f} s"
        + (" (beside other phases)" if beside is not None else "")
        + f": the lighthouse CLI ({json.dumps(summ['dashboard'])}), "
        f"examples/train_ddp_torch.py MODEL=lm under the launcher with hot "
        f"spares, {res['steps']} steps, durable every {res['every']}, bf16 "
        f"heal wire; lm fleet {summ['fleet_s']} s")
    log(f"  quickstart kill -> first commit of the promoted spare "
        f"{summ['kill_to_first_commit_s']} s (kill -> the spare's Manager "
        f"{summ['kill_to_manager_s']} s, -> promoted by the launcher "
        f"{summ['kill_to_promoted_s']} s; killed at group 1's step "
        f"{summ['kill_seen_step']}, healed at step {summ['heal_step']})")
    log(f"  quickstart handover {json.dumps(summ['handover'])}: each heal "
        f"left the state its peer served, params bit for bit, moments that "
        f"state's rounded to bf16; K3 bit for bit against its plain version "
        f"over the spare's heal staging")
    log(f"  quickstart heal {json.dumps(summ['heal'])}; both groups at step "
        f"{res['steps']}, batches_committed {summ['batches_committed']}; "
        f"params apart by {summ['param_drift']:.3g} (bound "
        f"{summ['drift_bound']:.3g}); durable restart restored step "
        f"{summ['restored_step']}")
    log(f"  quickstart K3 launches in the fleet "
        f"{summ['launches'].get('cast_bf16', 0)}; launches "
        f"{json.dumps(summ['launches'])}")
    log(f"  quickstart step p50 ms {json.dumps(summ['step_ms_p50'])}; the "
        f"manager's timers, p50 ms (quorum overlaps the forward/backward): "
        f"{json.dumps(summ['timers_p50_ms'])}")
    log(f"  quickstart a fresh process to its first commit, s: "
        f"{json.dumps(summ['first_step'])}")


# -- the accelerator-native data plane --------------------------------------------

# iso flash: ISO_WARM_STEPS untimed, ISO_STEPS timed fault-free steps; then
# group 1 SIGKILLs its child mid-op (both members discard, the next quorum
# respawns, ISO_KILL_TAIL steps commit), then SIGSTOPs it (the stall
# verdict; ISO_STALL_TAIL steps commit after it).
ISO_WARM_STEPS = 1
ISO_STEPS = 3
ISO_KILL_TAIL = 2
ISO_STALL_TAIL = 1
ISO_OP_TIMEOUT_S = 30
ISO_STALL_MS = 1000    # TORCHFT_ISO_STALL_MS: the stall verdict's grace
# the stall verdict lands within the grace plus the op's staging (the d2h
# of the payload) and a liveness tick; this much is allowed on top
ISO_STALL_SLACK_S = 3.0
XLA_DENSE_STEPS = 2    # timed xla dense steps after one warm-up
XLA_HEAL_STEPS = 2     # steps all three take after the join
ADAPTIVE_ISO_PROBE_STEPS = 2
ADAPTIVE_ISO_LOCKED_STEPS = 1
ADAPTIVE_ISO_CANDIDATES = ["blocking", "plan", "plan_devpack", "pipelined",
                           "xla_iso"]


def _n_params(params) -> int:
    from torchft_tpu_torch._tree import flatten

    return sum(p.numel() for p in flatten(params)[0])


def _step_recorder(ddp, manager, state, cfg: dict, device: torch.device):
    """``(rows, step)``: ``step(label)`` runs one guarded blocking step
    and logs its outcome and, on a commit, the params' checksum."""
    rows: list = []
    box = {"i": 0}

    def step(label: str) -> None:
        t0 = time.time()
        committed, err = _guarded_step(ddp, manager,
                                       _tokens(cfg, box["i"], device))
        box["i"] += 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rows.append({
            "label": label, "t0": t0, "t1": time.time(),
            "committed": committed, "qid": manager._quorum_id,
            "err": None if err is None
            else f"{type(err).__name__}: {str(err)[:200]}",
            "checksum": _checksum(state.params) if committed else None})

    return rows, step


def _lm_worker_state(cfg: dict, device: torch.device):
    """The worker's model config, FTTrainState (AdamW) and counted
    gradient function."""
    import torchft_tpu_torch as tft
    from torchft_tpu_torch.models import transformer as tt

    model_cfg = tt.TransformerConfig(**cfg["lm"])
    model = tt.TransformerLM(model_cfg, seed=0, device=device)
    state = tft.FTTrainState(model.params(), tft.AdamW(1e-3, weight_decay=1e-4))
    model_grad_fn = tt.make_grad_fn(model_cfg)
    calls = [0]

    def grad_fn(params, tokens):
        calls[0] += 1
        return model_grad_fn(params, tokens)

    return model_cfg, state, grad_fn, calls


def iso_worker(cfg: dict) -> None:
    """The iso flash role: the flash LM on Manager(iso_collectives=
    IsolatedXLACollectives) + PipelinedDDP(transport="iso",
    compress="q8") blocking steps (K1a/K1b quantize, K2 decodes the dq
    payload the child's gloo group sums on the host). Group 1 SIGKILLs
    its child mid-op once, then SIGSTOPs it once; a wrapper of the
    plane's allreduce logs every iso op's outcome and times."""
    import signal
    from datetime import timedelta

    import torchft_tpu_torch as tft
    from torchft_tpu_torch.ops import quantize_kernels as qk

    g, workdir = cfg["group"], cfg["workdir"]
    device = torch.device(cfg["device"])
    model_cfg, state, grad_fn, grad_calls = _lm_worker_state(cfg, device)
    iso = tft.IsolatedXLACollectives(
        timeout=timedelta(seconds=ISO_OP_TIMEOUT_S),
        connect_timeout=timedelta(seconds=60))
    collectives = tft.HostCollectives()
    manager = tft.Manager(
        collectives=collectives, iso_collectives=iso,
        load_state_dict=state.load_state_dict, state_dict=state.state_dict,
        min_replica_size=2, rank=0, world_size=1,
        lighthouse_addr=cfg["lighthouse"], replica_id=f"g{g}", device=device,
        use_async_quorum=False)
    ddp = tft.PipelinedDDP(manager, state, grad_fn, compress="q8",
                           transport="iso")
    ops: list = []
    faults: dict = {}
    dispatch = iso.allreduce

    def kill_child() -> None:
        pid = iso.child_pid()
        faults["killed"] = {"pid": pid, "t": time.time()}
        if pid is not None:
            os.kill(pid, signal.SIGKILL)

    def traced(*args, **kw):
        work = dispatch(*args, **kw)
        t_dispatch = time.time()
        delay = faults.pop("kill_after", None)
        if delay is not None:
            threading.Timer(delay, kill_child).start()

        def done(f) -> None:
            exc = f.exception()
            ops.append({"t_dispatch": t_dispatch, "t_done": time.time(),
                        "error": None if exc is None else type(exc).__name__,
                        "msg": None if exc is None else str(exc)[:300]})

        work.add_done_callback(done)
        return work

    iso.allreduce = traced
    rows, step = _step_recorder(ddp, manager, state, cfg, device)
    out: dict = {"group": g, "n_layers": model_cfg.n_layers,
                 "n_params": _n_params(state.params)}
    try:
        qk.reset_launch_counts()
        for _ in range(ISO_WARM_STEPS):
            step("warm")
        out["warm_stats"] = iso.pop_op_stats()
        for _ in range(ISO_STEPS):
            step("timed")
        out["timed_stats"] = timed = iso.pop_op_stats()
        out["status"] = iso.child_status().wait()
        if g == 1:
            # fire once the parent has staged the payload and the child is
            # reducing it
            ar = [s for s in timed if s["op"] == "allreduce"]
            faults["kill_after"] = (
                _median([s["pack"] + s["d2h"] for s in ar])
                + 0.25 * _median([s["child_s"] for s in ar]))
        step("kill")
        for _ in range(ISO_KILL_TAIL):
            step("after kill")
        if g == 1:
            pid = iso.child_pid()
            faults["stopped"] = {"pid": pid, "t": time.time()}
            os.kill(pid, signal.SIGSTOP)
        step("stall")
        for _ in range(ISO_STALL_TAIL):
            step("after stall")
        out["fault_stats"] = iso.pop_op_stats()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                device)
        out.update(rows=rows, ops=ops, faults=faults,
                   launches=dict(qk.launch_counts), grad_passes=grad_calls[0],
                   digest=_digest(state.params), step=manager.current_step())
    finally:
        manager.shutdown()
        collectives.shutdown()
    with open(os.path.join(workdir, f"result_{g}.json"), "w") as f:
        json.dump(out, f)


def xla_worker(cfg: dict) -> None:
    """The xla dense roles: the dense LM with the in-process
    XLACollectives (``cfg["backend"]``) as the Manager's data plane,
    PipelinedDDP(transport="legacy", compress="q8") blocking steps on card
    tensors. A founder then runs allreduce / allgather / broadcast on the
    live plane, offers a card tensor to the gloo group itself (does this
    torch build's gloo take one?), and trains on until a late third
    member has joined; every configure logs the params' checksum before
    and after it, which must not change."""
    from datetime import timedelta

    import torchft_tpu_torch as tft
    from torchft_tpu_torch.ops import quantize_kernels as qk

    g, workdir = cfg["group"], cfg["workdir"]
    device = torch.device(cfg["device"])
    model_cfg, state, grad_fn, grad_calls = _lm_worker_state(cfg, device)
    plane = tft.XLACollectives(timeout=timedelta(seconds=30),
                               connect_timeout=timedelta(seconds=60),
                               backend=cfg["backend"])
    plane.register_state(state)
    configures: list = []
    configure = plane.configure

    def logged_configure(store_addr, rank, world_size, **kw):
        before = _checksum(state.params)
        t0 = time.perf_counter()
        configure(store_addr, rank, world_size, **kw)
        configures.append({"world": world_size, "before": before,
                           "after": _checksum(state.params),
                           "s": time.perf_counter() - t0})

    plane.configure = logged_configure
    manager = tft.Manager(
        collectives=plane, load_state_dict=state.load_state_dict,
        state_dict=state.state_dict, min_replica_size=2, rank=0,
        world_size=1, lighthouse_addr=cfg["lighthouse"], replica_id=f"g{g}",
        device=device, use_async_quorum=False)
    ddp = tft.PipelinedDDP(manager, state, grad_fn, compress="q8",
                           transport="legacy")
    rows, step = _step_recorder(ddp, manager, state, cfg, device)
    out: dict = {"group": g, "role": cfg["role"], "backend": plane.backend}
    try:
        qk.reset_launch_counts()
        if cfg["role"] == "xla_dense_late":
            # heartbeating from construction: the next quorum waits for us
            open(os.path.join(workdir, "late_up"), "w").close()
        else:
            step("warm")
            plane.pop_op_stats()
            for _ in range(XLA_DENSE_STEPS):
                step("timed")
            out["op_split"] = _op_split(plane.pop_op_stats())
            out["plane_ops"] = _xla_plane_ops(plane, g, device)
            open(os.path.join(workdir, f"ready_{g}"), "w").close()
            _wait_for(os.path.join(workdir, "late_up"), 300)
        joined = None
        while joined is None or manager.current_step() < joined + XLA_HEAL_STEPS:
            step("join" if joined is None else "after join")
            if joined is None and plane.size() == 3 and rows[-1]["committed"]:
                joined = manager.current_step() - 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out.update(rows=rows, configures=configures,
                   launches=dict(qk.launch_counts), grad_passes=grad_calls[0],
                   digest=_digest(state.params), step=manager.current_step(),
                   heals=manager.metrics().snapshot()["counters"].get(
                       "heals", 0))
    finally:
        manager.shutdown()
        plane.shutdown()
    with open(os.path.join(workdir, f"result_{g}.json"), "w") as f:
        json.dump(out, f)


def _xla_plane_ops(plane, g: int, device: torch.device) -> dict:
    """allreduce (AVG), allgather and broadcast on the live XLACollectives
    over card tensors, and a card tensor handed to its gloo group
    directly: whether this torch build's gloo takes one."""
    from torchft_tpu_torch.collectives import ReduceOp

    x = {"x": torch.full((4096,), float(g + 1), device=device),
         "i": torch.arange(8, dtype=torch.int32, device=device) * (g + 1)}
    avg = plane.allreduce(x, ReduceOp.AVG).wait()
    gathered = plane.allgather(x).wait()
    bcast = plane.broadcast(x, root=1).wait()
    plane.barrier().wait()
    leaves = [avg["x"], avg["i"], bcast["x"]] + [m["x"] for m in gathered]
    out = {"avg": float(avg["x"][0]), "avg_i": avg["i"].tolist(),
           "gathered": [float(m["x"][0]) for m in gathered],
           "broadcast": float(bcast["x"][0]),
           "on_device": all(l.device.type == device.type for l in leaves)}
    gloo_card = None
    if device.type == "cuda" and plane.backend == "gloo":
        t = torch.full((1024,), float(g + 1), device=device)
        try:
            plane.global_mesh().allreduce([t]).wait()
            torch.cuda.synchronize(device)
            gloo_card = {"accepted": True, "sum": float(t[0])}
        except Exception as e:  # noqa: BLE001 - the verdict is the finding
            gloo_card = {"accepted": False,
                         "error": f"{type(e).__name__}: {str(e)[:300]}"}
    out["gloo_takes_card_tensors"] = gloo_card
    return out


def nccl_probe_worker(cfg: dict) -> None:
    """One of two processes on the one card: an XLACollectives(backend=
    "nccl") configure (a ProcessGroupNCCL, initialised eagerly) and one
    allreduce. Writes the verdict, or the refusal's text."""
    from datetime import timedelta

    import torchft_tpu_torch as tft

    g, workdir = cfg["group"], cfg["workdir"]
    out: dict = {"group": g}
    t0 = time.perf_counter()
    try:
        torch.cuda.set_device(0)
        plane = tft.XLACollectives(timeout=timedelta(seconds=20),
                                   connect_timeout=timedelta(seconds=30),
                                   backend="nccl")
        plane.configure(cfg["store"] + "/nccl", g, 2)
        y = plane.allreduce(torch.full((1024,), float(g + 1),
                                       device="cuda")).wait()
        out.update(accepted=True, sum=float(y[0]))
        plane.shutdown()
    except Exception as e:  # noqa: BLE001 - the refusal is the finding
        out.update(accepted=False, error=f"{type(e).__name__}: {e}"[:1200])
    out["s"] = time.perf_counter() - t0
    with open(os.path.join(workdir, f"result_{g}.json"), "w") as f:
        json.dump(out, f)


def adaptive_iso_worker(cfg: dict) -> None:
    """AdaptiveDDP(compress="q8") on the dense LM with an isolated plane
    on the Manager: five candidates (blocking, plan on the host pack,
    plan_devpack, pipelined, xla_iso), ADAPTIVE_ISO_PROBE_STEPS each after
    the anchor, then ADAPTIVE_ISO_LOCKED_STEPS locked."""
    from datetime import timedelta

    import torchft_tpu_torch as tft
    from torchft_tpu_torch.ops import quantize_kernels as qk

    g, workdir = cfg["group"], cfg["workdir"]
    device = torch.device(cfg["device"])
    model_cfg, state, grad_fn, grad_calls = _lm_worker_state(cfg, device)
    iso = tft.IsolatedXLACollectives(
        timeout=timedelta(seconds=ISO_OP_TIMEOUT_S),
        connect_timeout=timedelta(seconds=60))
    collectives = tft.HostCollectives()
    manager = tft.Manager(
        collectives=collectives, iso_collectives=iso,
        load_state_dict=state.load_state_dict, state_dict=state.state_dict,
        min_replica_size=2, rank=0, world_size=1,
        lighthouse_addr=cfg["lighthouse"], replica_id=f"g{g}", device=device,
        use_async_quorum=False)
    ddp = tft.AdaptiveDDP(manager, state, grad_fn, compress="q8",
                          probe_steps=ADAPTIVE_ISO_PROBE_STEPS)
    out: dict = {"group": g, "n_layers": model_cfg.n_layers,
                 "candidates": list(ddp._candidates)}
    try:
        qk.reset_launch_counts()
        steps = (1 + ADAPTIVE_ISO_PROBE_STEPS * len(ddp._candidates)
                 + ADAPTIVE_ISO_LOCKED_STEPS)
        step_s, losses = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            losses.append(float(ddp.step(_tokens(cfg, i, device))))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_s.append(time.perf_counter() - t0)
        out["flush"] = ddp.flush()
        out.update(launches=dict(qk.launch_counts), grad_passes=grad_calls[0],
                   decision=ddp.decision, mode=ddp.mode, step_s=step_s,
                   losses=losses, digest=_digest(state.params), steps=steps,
                   committed=manager.current_step(),
                   iso_paths=sorted({s.get("path") for s in
                                     iso.pop_op_stats()}))
    finally:
        manager.shutdown()
        collectives.shutdown()
    with open(os.path.join(workdir, f"result_{g}.json"), "w") as f:
        json.dump(out, f)


def phase_nccl_probe(workdir: str) -> dict:
    """Two processes ask NCCL for one communicator over the one card.
    Returns both verdicts; a process that hangs is killed at the bound
    and counts as a refusal."""
    import torchft_tpu_torch as tft

    store = tft.Store()
    t0 = time.perf_counter()
    procs = []
    try:
        procs = [_spawn({"role": "nccl_probe", "group": g, "workdir": workdir,
                         "store": store.address()}, workdir) for g in (0, 1)]
        deadline = time.monotonic() + 120
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        store.shutdown()
    results = []
    for g in (0, 1):
        try:
            with open(os.path.join(workdir, f"result_{g}.json")) as f:
                results.append(json.load(f))
        except OSError:
            with open(os.path.join(workdir, f"worker_{g}.log")) as f:
                tail = f.read()[-600:]
            results.append({"group": g, "accepted": False,
                            "error": f"no verdict (exit "
                                     f"{procs[g].returncode}): {tail}"})
    accepted = all(r["accepted"] and r.get("sum") == 3.0 for r in results)
    return {"accepted": accepted, "results": results,
            "total_s": time.perf_counter() - t0}


def phase_xla_dense(workdir: str, device: str = "cuda", lm: dict = LM,
                    batch: int = BATCH, seq: int = SEQ,
                    backend: str = "gloo") -> dict:
    """Two dense groups on the in-process XLACollectives, then a third
    joins and heals."""
    import torchft_tpu_torch as tft

    lighthouse = tft.Lighthouse(min_replicas=2, join_timeout_ms=10000,
                                quorum_tick_ms=50, heartbeat_timeout_ms=10000)
    base = {"lighthouse": lighthouse.address(), "workdir": workdir,
            "device": device, "lm": lm, "batch": batch, "seq": seq,
            "backend": backend}
    t0 = time.perf_counter()
    procs = []
    try:
        procs = [_spawn({**base, "group": g, "role": "xla_dense"}, workdir)
                 for g in (0, 1)]
        deadline = time.monotonic() + 300
        for g in (0, 1):
            path = os.path.join(workdir, f"ready_{g}")
            while not os.path.exists(path):
                if any(p.poll() not in (None, 0) for p in procs):
                    _join(procs, deadline, workdir)
                if time.monotonic() > deadline:
                    fail("xla dense founders never finished their steps")
                time.sleep(0.1)
        procs.append(_spawn({**base, "group": 2, "role": "xla_dense_late"},
                            workdir))
        _join(procs, deadline, workdir)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        lighthouse.shutdown()
    results = []
    for g in (0, 1, 2):
        with open(os.path.join(workdir, f"result_{g}.json")) as f:
            results.append(json.load(f))
    return {"results": results, "total_s": time.perf_counter() - t0}


def check_xla_dense(res: dict, on_card: bool = True) -> dict:
    """Every step commits; each configure (2, then 3 members) leaves the
    params' bits as they were; the plane's ops give the exact results on
    the leaves' devices; the three groups end bit-identical; K1a/K1b/K2
    launch once per step (the legacy q8 payload)."""
    results = res["results"]
    launches: dict = {}
    for r in results:
        g = r["group"]
        if not all(row["committed"] for row in r["rows"]):
            fail(f"xla dense group {g}: a step was discarded: {r['rows']}")
        for c in r["configures"]:
            if c["before"] != c["after"]:
                fail(f"xla dense group {g}: a configure changed the state: {c}")
        worlds = [c["world"] for c in r["configures"]]
        if 3 not in worlds:
            fail(f"xla dense group {g}: never configured at 3: {worlds}")
        steps = len(r["rows"])
        want = dict.fromkeys(r["launches"], 0)
        if on_card:
            want.update({k: steps for k in ("q8_absmax", "q8_quantize",
                                            "q8_dequantize")})
        if r["launches"] != want:
            fail(f"xla dense group {g}: launches {r['launches']} != {want}")
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
        ops = r.get("plane_ops")
        if ops is not None:
            if (ops["avg"] != 1.5 or ops["avg_i"] != [i * 3 // 2 for i in
                                                      range(8)]
                    or ops["gathered"] != [1.0, 2.0] or ops["broadcast"] != 2.0
                    or not ops["on_device"]):
                fail(f"xla dense group {g}: plane ops {ops}")
    if len({r["digest"] for r in results}) != 1:
        fail("xla dense groups' params differ at the end")
    if results[2]["heals"] < 1:
        fail("the xla dense joiner never healed")
    return {"launches": launches, "backend": results[0]["backend"],
            "configure_s": [[round(c["s"], 3) for c in r["configures"]]
                            for r in results],
            "step_ms": [[round(1e3 * (row["t1"] - row["t0"]), 1)
                         for row in r["rows"]] for r in results],
            "op_split": results[0].get("op_split"),
            "plane_ops": results[0]["plane_ops"],
            "gloo_takes_card_tensors": [r.get("plane_ops", {}).get(
                "gloo_takes_card_tensors") for r in results[:2]]}


def phase_iso_flash(workdir: str, device: str = "cuda", lm: dict = BIG_LM,
                    batch: int = BIG_BATCH, seq: int = BIG_SEQ) -> dict:
    """Two flash groups on the isolated data plane (a flat lighthouse)."""
    base = {"device": device, "role": "iso_flash", "lm": lm, "batch": batch,
            "seq": seq, "env": {"TORCHFT_ISO_STALL_MS": str(ISO_STALL_MS)}}
    return _run_groups(workdir, base, [{}, {}])


def check_iso_flash(res: dict, on_card: bool = True, lm: dict = BIG_LM) -> dict:
    """Every op stamps path "psum"; the fault-free steps commit on both
    groups with equal params after each; group 1's child SIGKILLed mid-op
    is a ChildDiedError there, both groups discard that step and commit
    the next ones equal again; its SIGSTOPped child is a
    ChildStalledError within the stall grace (plus the op's staging),
    again discarded on both; the child held no JAX and no CUDA context;
    K1a/K1b/K2 launch once per step, K4/K5 once per gradient pass."""
    results = res["results"]
    launches: dict = {}
    for r in results:
        g = r["group"]
        stats = r["warm_stats"] + r["timed_stats"] + r["fault_stats"]
        paths = {s["path"] for s in stats}
        if paths != {"psum"}:
            fail(f"iso flash group {g}: op paths {sorted(paths)} (want psum)")
        labels = [row["label"] for row in r["rows"]]
        for row in r["rows"]:
            want = row["label"] not in ("kill", "stall")
            if row["committed"] is not want:
                fail(f"iso flash group {g}: step {row['label']} committed "
                     f"{row['committed']}: {row['err']}")
        ar = [s for s in r["timed_stats"] if s["op"] == "allreduce"]
        if len(ar) != ISO_STEPS or any(s["bytes"] != 4 * r["n_params"]
                                       for s in ar):
            fail(f"iso flash group {g}: timed ops {ar}")
        if r["status"]["foreign_modules"] or r["status"]["cuda_initialized"]:
            fail(f"iso flash group {g}: the child {r['status']}")
        steps = len(labels)
        want = dict.fromkeys(r["launches"], 0)
        want.update(_flash_want(r, r["grad_passes"], on_card, lm))
        if on_card:
            want.update({k: steps for k in ("q8_absmax", "q8_quantize",
                                            "q8_dequantize")})
        if r["launches"] != want:
            fail(f"iso flash group {g}: launches {r['launches']} != {want}")
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    a, b = results
    for ra, rb in zip(a["rows"], b["rows"]):
        if ra["committed"] and rb["committed"] and ra["checksum"] != rb["checksum"]:
            fail(f"iso flash: params differ after step {ra['label']}")
    if a["digest"] != b["digest"]:
        fail("iso flash groups' params differ at the end")
    # the faults, on group 1 (the ops in order: warm, timed, kill, ...)
    killed, stopped = b["faults"]["killed"], b["faults"]["stopped"]
    kill_op = b["ops"][ISO_WARM_STEPS + ISO_STEPS]
    if kill_op["error"] != "ChildDiedError":
        fail(f"iso flash: the killed child's op ended {kill_op}")
    if a["ops"][ISO_WARM_STEPS + ISO_STEPS]["error"] is None:
        fail("iso flash: the survivor's op of the kill step succeeded")
    stall_op = b["ops"][ISO_WARM_STEPS + ISO_STEPS + 1 + ISO_KILL_TAIL]
    if stall_op["error"] != "ChildStalledError":
        fail(f"iso flash: the stopped child's op ended {stall_op}")
    stall_s = stall_op["t_done"] - stall_op["t_dispatch"]
    if stall_s > ISO_STALL_MS / 1e3 + ISO_STALL_SLACK_S:
        fail(f"iso flash: the stall verdict took {stall_s:.2f} s")
    after_kill = [row for row in b["rows"] if row["label"] == "after kill"]
    respawns = [s for s in b["fault_stats"] if s["op"] == "configure"]
    timed_rows = [row for r in results for row in r["rows"]
                  if row["label"] == "timed"]
    split = {}
    for key in ("pack", "d2h", "ring", "child_s", "h2d"):
        split[f"{key}_ms"] = round(1e3 * _median(
            [s[key] for s in a["timed_stats"] if s["op"] == "allreduce"]), 3)
    a_ar = [s for s in a["timed_stats"] if s["op"] == "allreduce"]
    split["bytes"] = a_ar[0]["bytes"]
    split["d2h_bytes"] = a_ar[0]["d2h_bytes"]
    return {
        "launches": launches,
        "step_ms_p50": _p50([row["t1"] - row["t0"] for row in timed_rows]),
        "step_ms_all": [round(1e3 * (row["t1"] - row["t0"]), 1)
                        for row in timed_rows],
        "split": split,
        "kill_to_error_s": round(kill_op["t_done"] - killed["t"], 4),
        "kill_in_op_s": round(killed["t"] - kill_op["t_dispatch"], 4),
        "kill_error": kill_op["msg"],
        "survivor_error": a["ops"][ISO_WARM_STEPS + ISO_STEPS]["msg"],
        "kill_to_commit_s": round(after_kill[0]["t1"] - killed["t"], 3),
        "stop_to_stall_s": round(stall_op["t_done"] - stopped["t"], 3),
        "dispatch_to_stall_s": round(stall_s, 3),
        "respawns": [{k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in s.items()} for s in respawns],
        "first_configure": {k: (round(v, 4) if isinstance(v, float) else v)
                            for k, v in b["warm_stats"][0].items()},
        "child": b["status"],
        "max_memory_allocated_gb": [
            round(r.get("max_memory_allocated", 0) / 2**30, 2)
            for r in results],
    }


def phase_adaptive_iso(workdir: str, device: str = "cuda", lm: dict = LM,
                       batch: int = BATCH, seq: int = SEQ) -> dict:
    """Two dense groups on AdaptiveDDP with an isolated plane."""
    base = {"device": device, "role": "adaptive_iso", "lm": lm,
            "batch": batch, "seq": seq,
            "env": {"TORCHFT_DEVICE_PACK": "auto"}}
    return _run_groups(workdir, base, [{}, {}])


def check_adaptive_iso(res: dict, on_card: bool = True) -> dict:
    """Both groups race the same five candidates, xla_iso among them
    with a clean probe (no failure sentinel), lock the same mode on the
    same decision and end bit-identical; every transaction committed and
    every iso op took the psum path."""
    results = res["results"]
    launches: dict = {}
    for r in results:
        g = r["group"]
        if r["candidates"] != ADAPTIVE_ISO_CANDIDATES:
            fail(f"adaptive dense group {g}: candidates {r['candidates']}")
        probe = (r["decision"] or {}).get("probe_s") or {}
        if set(probe) != set(ADAPTIVE_ISO_CANDIDATES) or any(
                v >= 1e9 for v in probe.values()):
            fail(f"adaptive dense group {g}: a candidate failed: "
                 f"{r['decision']}")
        if r["committed"] != r["steps"]:
            fail(f"adaptive dense group {g}: {r['committed']} of "
                 f"{r['steps']} transactions committed")
        if r["iso_paths"] != ["psum"]:
            fail(f"adaptive dense group {g}: iso paths {r['iso_paths']}")
        if not all(map(_finite, r["losses"])):
            fail(f"adaptive dense group {g}: non-finite loss {r['losses']}")
        if on_card:
            for k in ("q8_absmax", "q8_quantize", "q8_dequantize"):
                if r["launches"].get(k, 0) < 1:
                    fail(f"adaptive dense group {g}: {k} never launched")
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    d0, d1 = results[0]["decision"], results[1]["decision"]
    if d0 != d1 or results[0]["mode"] != results[1]["mode"]:
        fail(f"adaptive dense groups locked differently: {d0} vs {d1}")
    if results[0]["digest"] != results[1]["digest"]:
        fail("adaptive dense groups' params differ after the flush")
    return {"launches": launches, "decision": d0, "mode": results[0]["mode"],
            "step_ms": [[round(1e3 * x, 1) for x in r["step_s"]]
                        for r in results]}


def _shm_df() -> str:
    try:
        return subprocess.run(["df", "-B1", "/dev/shm"], capture_output=True,
                              text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"df failed: {e}"


def iso_phases(by_phase: dict, flash_step_ms: "float | None" = None) -> None:
    """The NCCL probe, xla dense, iso flash and adaptive dense phases:
    each runs, is checked and logged, and puts its launch counts into
    ``by_phase``. ``flash_step_ms``: the plan-q8 flash step p50 of the
    same call, printed beside the iso flash step."""
    _phase("nccl probe")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as workdir:
        nres = phase_nccl_probe(workdir)
    log(f"  nccl probe {nres['total_s']:.1f} s: two ProcessGroupNCCL ranks on "
        f"one card {'ACCEPTED' if nres['accepted'] else 'REFUSED'}: "
        f"{json.dumps(nres['results'])}")
    backend = "nccl" if nres["accepted"] else "gloo"
    _phase("xla dense")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_xla_") as workdir:
        xres = phase_xla_dense(workdir, backend=backend)
        xsum = check_xla_dense(xres)
    by_phase["xla dense"] = xsum.pop("launches")
    log(f"  xla dense {xres['total_s']:.1f} s (XLACollectives backend "
        f"{xsum['backend']}, two dense groups then a third joining): "
        f"{json.dumps(xsum)}")
    _phase("iso flash")
    log(f"  /dev/shm before: {_shm_df()}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_iso_") as workdir:
        ires = phase_iso_flash(workdir)
        isum = check_iso_flash(ires)
    by_phase["iso flash"] = isum.pop("launches")
    log(f"  iso flash {ires['total_s']:.1f} s: step p50 "
        f"{isum['step_ms_p50']:.3f} ms (all: {isum['step_ms_all']}) against "
        f"the plan-q8 flash step p50 "
        f"{'not run' if flash_step_ms is None else f'{flash_step_ms:.3f} ms'};"
        f" group 0's op split (medians over the timed steps) "
        f"{json.dumps(isum['split'])}")
    log(f"  iso flash faults: {json.dumps({k: v for k, v in isum.items() if k not in ('split', 'step_ms_all', 'step_ms_p50')})}")
    _phase("adaptive dense")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_adiso_") as workdir:
        ares = phase_adaptive_iso(workdir)
        asum = check_adaptive_iso(ares)
    by_phase["adaptive dense"] = asum.pop("launches")
    log(f"  adaptive dense {ares['total_s']:.1f} s: {json.dumps(asum)}")


# -- the model-parallel phases: a mesh of processes per replica group -----------

# two replica groups of two ranks each, one process per rank, all on the
# one card (gloo groups, card tensors staged through the host)
PAR_GROUPS, PAR_RANKS = 2, 2
PAR_WARM, PAR_STEPS = 1, 1      # untimed and timed blocking steps a sub-phase
PAR_TAIL_STEPS = 1              # tp flash: steps the groups take after the heal
PAR_LOSS_RTOL = 3e-3            # sharded against unsharded bf16 (tests/test_moe.py)
# the sub-phases in launch order (tp flash last: its kill ends the launch)
# and their models at full width: the CNN demo family, bench.py's big LM
# with its depth cut to PAR_LM_LAYERS (8 took 106-128 s of the default
# run's launch, 4 took 73-95 s), the MoE family's defaults
PAR_LM_LAYERS = 2
PAR_LM = {**BIG_LM, "n_layers": PAR_LM_LAYERS}
PAR_SIZES = {
    "cnn": {"model": {}, "batch": 64},
    "cp ulysses": {"model": PAR_LM, "batch": 8, "seq": 2049},
    "cp ring": {"model": PAR_LM, "batch": 4, "seq": 2049},
    "pp flash": {"model": PAR_LM, "batch": 8, "seq": BIG_SEQ, "micro": 4},
    "ep moe": {"model": {"use_flash": True}, "batch": 8, "seq": 1024},
    "tp flash": {"model": PAR_LM, "batch": 4, "seq": BIG_SEQ},
}
PAR_AXES = {"cnn": {"data": 1}, "cp ulysses": {"seq": 2}, "cp ring": {"seq": 2},
            "pp flash": {"pipe": 2}, "ep moe": {"expert": 2},
            "tp flash": {"model": 2}}
# the kernels each sub-phase must launch (summed over its ranks)
PAR_KERNELS = {
    "cnn": ("q8_absmax", "q8_quantize"),
    "cp ulysses": ("q8_absmax", "q8_quantize", "flash_fwd", "flash_bwd"),
    "cp ring": ("q8_absmax", "q8_quantize"),
    "pp flash": ("q8_absmax", "q8_quantize", "flash_fwd", "flash_bwd"),
    "ep moe": ("q8_absmax", "q8_quantize", "flash_fwd", "flash_bwd"),
    "tp flash": ("q8_absmax", "q8_quantize", "flash_fwd", "flash_bwd"),
}


_PAR_WHOLE: dict = {}  # (init fn, config, seed) -> whole params on the host


def _par_init(init, cfg, seed: int, device: torch.device):
    """``init(cfg, seed, "cpu")`` drawn once per process (the LM
    sub-phases share seed 0's weights), copied to ``device``."""
    from torchft_tpu_torch._tree import tree_map

    key = (init.__module__, repr(cfg), seed)
    if key not in _PAR_WHOLE:
        _PAR_WHOLE[key] = init(cfg, seed, "cpu")
    return tree_map(lambda l: l.to(device), _PAR_WHOLE[key])


def _par_model(sub: str, sizes: dict, mesh, device: torch.device, seed: int):
    """``(whole params, rules, loss_fn(params, batch) on the mesh, the
    unsharded loss_fn)`` of a sub-phase: the model at its sizes, from
    ``seed``."""
    import functools

    from torchft_tpu_torch import parallel as par
    from torchft_tpu_torch import pipeline as tpp
    from torchft_tpu_torch._tree import tree_map
    from torchft_tpu_torch.models import cnn as tcnn
    from torchft_tpu_torch.models import moe as tmoe
    from torchft_tpu_torch.models import transformer as tt

    spec = sizes[sub]
    if sub == "cnn":
        cfg = tcnn.CNNConfig(**spec["model"])
        return (_par_init(tcnn.init_params, cfg, seed, device),
                tcnn.param_sharding_rules(cfg),
                functools.partial(tcnn.loss_fn, cfg),
                functools.partial(tcnn.loss_fn, cfg))
    if sub == "ep moe":
        cfg = tmoe.MoEConfig(**spec["model"])
        rules = par.restrict_rules(tmoe.param_sharding_rules(cfg), mesh)
        return (_par_init(tmoe.init_params, cfg, seed, device), rules,
                functools.partial(tmoe.loss_fn,
                                  dataclasses.replace(cfg, cp_mesh=mesh)),
                functools.partial(tmoe.loss_fn, cfg))
    cfg = tt.TransformerConfig(**spec["model"])
    plain = functools.partial(tt.loss_fn, cfg)
    if sub == "pp flash":
        raw = _par_init(tt.init_params, cfg, seed, device)
        whole = {"backbone": {k: v for k, v in raw.items() if k != "blocks"},
                 "stacked": tpp.stack_blocks(raw["blocks"])}
        del raw
        rules = {"backbone": tree_map(lambda l: (), whole["backbone"]),
                 "stacked": tpp.stage_specs(whole["stacked"])}

        def pp_loss(params, tokens):
            x = tt.embed_tokens(cfg, params["backbone"], tokens[:, :-1])
            x = tpp.pipeline_blocks(functools.partial(tt._block, cfg),
                                    params["stacked"], x, mesh=mesh,
                                    microbatches=spec["micro"])
            return tt.next_token_loss(tt.readout(cfg, params["backbone"], x),
                                      tokens[:, 1:])

        def pp_plain(params, tokens):
            n = params["stacked"]["ln1"]["scale"].shape[0]
            blocks = [tree_map(lambda l: l[i], params["stacked"])
                      for i in range(n)]
            return plain({**params["backbone"], "blocks": blocks}, tokens)

        return whole, rules, pp_loss, pp_plain
    extra = {}
    if sub.startswith("cp "):
        extra = dict(cp_seq_axis="seq", cp_batch_axis=None,
                     cp_strategy=sub.split()[1])
    rules = par.restrict_rules(tt.param_sharding_rules(cfg), mesh)
    return (_par_init(tt.init_params, cfg, seed, device), rules,
            functools.partial(tt.loss_fn, dataclasses.replace(
                cfg, cp_mesh=mesh, **extra)), plain)


def _par_batch(sub: str, sizes: dict, step: int, device: torch.device):
    """The whole batch of a step (the same on every rank of both groups):
    tokens, or CIFAR-10-shaped images and labels for the CNN."""
    spec = sizes[sub]
    gen = torch.Generator().manual_seed(7000 + 100 * list(PAR_SIZES).index(sub)
                                        + step)
    if sub == "cnn":
        from torchft_tpu_torch.models import cnn as tcnn

        cfg = tcnn.CNNConfig(**spec["model"])
        images = torch.randn((spec["batch"], cfg.image_size, cfg.image_size,
                              cfg.channels), generator=gen)
        labels = torch.randint(0, cfg.classes, (spec["batch"],), generator=gen)
        return images.to(device), labels.to(device)
    vocab = spec["model"].get("vocab_size", 32768)
    return torch.randint(0, vocab, (spec["batch"], spec["seq"]),
                         generator=gen).to(device)


GLOO_PROBE_OPS = ("allreduce", "allgather_into_tensor", "reduce_scatter_tensor",
                  "all_to_all_single", "send_recv")


def gloo_probe_worker(cfg: dict) -> None:
    """One rank of a two-process gloo group handing one collective a card
    tensor directly (the mesh stages card tensors through the host
    whatever the verdict). Prints the verdict: the op ran and gave the
    right values, or what it raised. A gloo transport that writes from a
    device pointer kills its process, which the harness reports."""
    import datetime

    import torch.distributed as dist

    op, rank = cfg["op"], cfg["rank"]
    device = torch.device(cfg["device"])
    tcp = dist.TCPStore("127.0.0.1", cfg["port"], is_master=False,
                        timeout=datetime.timedelta(seconds=60))
    pg = dist.ProcessGroupGloo(dist.PrefixStore(f"gloo_probe/{op}", tcp), rank,
                               2, datetime.timedelta(seconds=20))
    x = torch.full((8,), float(rank + 1), device=device)
    try:
        if op == "allreduce":
            out = x.clone()
            pg.allreduce([out]).wait()
            ok = bool((out == 3).all())
        elif op == "allgather_into_tensor":
            out = torch.empty(16, device=device)
            pg._allgather_base(out, x).wait()
            ok = bool((out[:8] == 1).all() and (out[8:] == 2).all())
        elif op == "reduce_scatter_tensor":
            out = torch.empty(4, device=device)
            pg._reduce_scatter_base(out, x.clone()).wait()
            ok = bool((out == 3).all())
        elif op == "all_to_all_single":
            out = torch.empty(8, device=device)
            pg.alltoall_base(out, x, [], [], dist.AllToAllOptions()).wait()
            ok = bool((out[:4] == 1).all() and (out[4:] == 2).all())
        else:
            if rank == 0:
                pg.send([x], 1, 0).wait()
                ok = True
            else:
                out = torch.empty(8, device=device)
                pg.recv([out], 0, 0).wait()
                ok = bool((out == 1).all())
        verdict = ("takes a card tensor" if ok
                   else "takes a card tensor, wrong values")
    except Exception as e:  # noqa: BLE001 - the verdict is the output
        verdict = f"refused: {type(e).__name__}: {str(e)[:160]}"
    print("VERDICT " + json.dumps({"op": op, "rank": rank,
                                   "verdict": verdict}), flush=True)
    try:
        pg.shutdown()
    except Exception:  # noqa: BLE001
        pass


def _gloo_verdicts(workdir: str, port: int, device: str) -> tuple:
    """Starts one pair of probe processes per op (all at once); returns
    ``(procs, collect)``, ``collect()`` waiting for them and giving each
    op's verdict (rank 0's, or how a rank's process died)."""
    procs = {}
    for op in GLOO_PROBE_OPS:
        for rank in (0, 1):
            logf = open(os.path.join(workdir, f"gloo_{op}_{rank}.log"), "w")
            procs[(op, rank)] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 json.dumps({"role": "gloo_probe", "op": op, "rank": rank,
                             "port": port, "device": device})],
                cwd=REPO, stdout=logf, stderr=subprocess.STDOUT)

    def collect() -> dict:
        verdicts = {}
        for (op, rank), p in procs.items():
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            with open(os.path.join(workdir, f"gloo_{op}_{rank}.log")) as f:
                text = f.read()
            line = next((l for l in text.splitlines()
                         if l.startswith("VERDICT ")), None)
            if line is None:
                tail = [l for l in text.splitlines() if l.strip()][-2:]
                verdicts[(op, rank)] = (f"killed its process (exit "
                                        f"{p.returncode}): "
                                        + " | ".join(tail)[:200])
            else:
                verdicts[(op, rank)] = json.loads(line[8:])["verdict"]
        out = {}
        for op in GLOO_PROBE_OPS:
            a, b = verdicts[(op, 0)], verdicts[(op, 1)]
            out[op] = a if a == b else {"rank 0": a, "rank 1": b}
        return out

    return procs, collect


def _par_progress(workdir: str, g: int, r: int, row: dict) -> None:
    with open(os.path.join(workdir, f"parprog_{g}_{r}.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")


def _par_rows(workdir: str, g: int, r: int) -> list:
    try:
        with open(os.path.join(workdir, f"parprog_{g}_{r}.jsonl")) as f:
            return [json.loads(l) for l in f if l.strip()]
    except OSError:
        return []


def _par_step(ddp, manager, batch) -> tuple:
    """One blocking step, as :func:`_guarded_step`, with its loss."""
    try:
        loss = ddp.blocking_step(batch)
        return bool(ddp.last_commit), manager.errored(), float(loss)
    except Exception as e:  # noqa: BLE001 - the worker retries
        try:
            if manager.errored() is None:
                manager.report_error(e)
            manager.should_commit()
        except Exception:  # noqa: BLE001
            pass
        return False, e, None


def parallel_worker(cfg: dict) -> None:
    """One rank of one replica group: each sub-phase builds its mesh (the
    group's ranks, gloo), its block of the model (``shard_pytree``), an
    FTTrainState (AdamW), a ``Manager(rank=r, world_size=2)`` with its own
    HostCollectives ring and PipelinedDDP(compress="q8") over
    ``build_grad_step``; blocking steps (warm-up, timed, and in tp flash
    a tail that the harness's kill interrupts), the per-step checksum, the
    mesh's collective seconds and the ring's op stats."""
    import datetime

    import torch.distributed as dist

    import torchft_tpu_torch as tft
    from torchft_tpu_torch import parallel as par
    from torchft_tpu_torch.ops import quantize_kernels as qk

    g, r, workdir = cfg["group"], cfg["rank"], cfg["workdir"]
    device = torch.device(cfg["device"])
    on_card = device.type == "cuda"
    sizes = cfg["sizes"]
    tcp = dist.TCPStore("127.0.0.1", cfg["mesh_port"], is_master=False,
                        timeout=datetime.timedelta(seconds=300))
    for sub in cfg["subs"]:
        world = 1 if sub == "cnn" else PAR_RANKS
        if r >= world:
            continue  # the CNN runs as groups of one rank
        out = {"group": g, "rank": r, "sub": sub, "pid": os.getpid()}
        log(f"[g{g}/r{r}] sub-phase {sub}")
        mesh = par.make_mesh(PAR_AXES[sub], rank=r, world_size=world,
                             store=tcp, prefix=f"{sub}/{cfg['incarnation']}/g{g}",
                             timeout=datetime.timedelta(seconds=300))
        whole, rules, loss_fn, plain = _par_model(sub, sizes, mesh, device,
                                                  cfg["seed"])
        if g == 0 and r == 0 and not cfg.get("restart"):
            # the unsharded loss of the same params and first batch
            with torch.no_grad():
                out["loss_unsharded"] = float(plain(
                    whole, _par_batch(sub, sizes, 0, device)))
        state = tft.FTTrainState(par.shard_pytree(whole, rules, mesh),
                                 tft.AdamW(1e-3, weight_decay=1e-4))
        del whole
        out["shard_params"] = _n_params(state.params)
        step_fn = par.build_grad_step(loss_fn, mesh, rules)
        collectives = tft.HostCollectives()
        manager = tft.Manager(
            collectives=collectives, load_state_dict=state.load_state_dict,
            state_dict=state.state_dict, min_replica_size=PAR_GROUPS,
            rank=r, world_size=world, store_addr=cfg["stores"][sub][str(g)],
            lighthouse_addr=cfg["lighthouses"][sub], replica_id=f"par_g{g}",
            device=device, quorum_timeout=datetime.timedelta(seconds=300),
            timeout=datetime.timedelta(seconds=120))
        ddp = tft.PipelinedDDP(manager, state, step_fn, compress="q8")
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        qk.reset_launch_counts()
        manager.observe_op_stats()
        mesh.pop_stats()
        rows, n = [], 0
        target = (PAR_WARM + PAR_STEPS + (PAR_TAIL_STEPS if sub == "tp flash"
                                          else 0))
        # tp flash's victim: group 1's first incarnation waits for its
        # SIGKILL once its timed steps are in (a kill point no race moves)
        victim = sub == "tp flash" and g == 1 and not cfg.get("restart")
        try:
            while manager.current_step() < target:
                if victim and manager.current_step() >= PAR_WARM + PAR_STEPS:
                    time.sleep(600)
                t0 = time.time()
                committed, err, loss = _par_step(
                    ddp, manager, _par_batch(sub, sizes, manager.current_step(),
                                             device))
                if on_card:
                    torch.cuda.synchronize(device)
                t1 = time.time()
                row = {"t0": t0, "t": t1, "n": n, "step": manager.current_step(),
                       "committed": committed, "pid": os.getpid(),
                       "loss": loss,
                       "checksum": _checksum(state.params) if committed else None,
                       "mesh": mesh.pop_stats(),
                       "ops": _op_split(manager.observe_op_stats()),
                       "heals": manager.metrics().snapshot()["counters"].get(
                           "heals", 0),
                       "err": None if err is None
                       else f"{type(err).__name__}: {str(err)[:200]}"}
                rows.append(row)
                if sub == "tp flash":
                    _par_progress(workdir, g, r, row)
                n += 1
                # only tp flash's tail (the kill) may fail a step: anything
                # else ends the launch at once, not at the peers' timeouts
                if err is not None and (sub != "tp flash" or n <= PAR_WARM
                                        + PAR_STEPS or n > 3 * target):
                    raise RuntimeError(f"{sub}: step {n - 1} failed: "
                                       f"{row['err']}")
            out["rows"] = rows
            out["launches"] = dict(qk.launch_counts)
            out["digest"] = _digest(state.params)
            out["fetch"] = manager.checkpoint_transport().last_fetch_stats
            if on_card:
                out["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                    device)
        finally:
            manager.shutdown()
            collectives.shutdown()
            mesh.shutdown()
        del ddp, state, step_fn
        if on_card:
            torch.cuda.empty_cache()
        with open(os.path.join(
                workdir, f"par_{sub.replace(' ', '_')}_{g}_{r}_"
                f"{cfg['incarnation']}.json"), "w") as f:
            json.dump(out, f)


def _par_spawn(cfg: dict, workdir: str) -> subprocess.Popen:
    """A rank process: warm from the pool, but cold for a restart (an
    incarnation after the first) after the SIGKILL."""
    name = f"parworker_{cfg['group']}_{cfg['rank']}_{cfg['incarnation']}.log"
    return _popen_worker(["--worker", json.dumps(cfg)],
                         os.path.join(workdir, name),
                         cold=cfg["incarnation"] > 0)


def _par_fail(procs: list, workdir: str, why: str) -> None:
    tails = []
    for p in procs:
        cfg = json.loads(p.args[-1])
        name = (f"parworker_{cfg['group']}_{cfg['rank']}_"
                f"{cfg['incarnation']}.log")
        with open(os.path.join(workdir, name)) as f:
            tails.append(f"--- {name} (exit {p.poll()}):\n{f.read()[-2500:]}")
    fail(why + "\n" + "\n".join(tails))


def phase_parallel(workdir: str, device: str = "cuda",
                   sizes: dict = PAR_SIZES) -> dict:
    """One launch of four worker processes (two replica groups of two
    ranks) that run the model-parallel sub-phases in turn against one
    lighthouse each; in tp flash, last, group 1's two processes wait
    once both have committed their timed steps, are SIGKILLed there and
    restarted from other weights, and each rank heals its block from
    group 0's."""
    import datetime

    import torch.distributed as dist

    import torchft_tpu_torch as tft
    from torchft_tpu_torch._native import Store
    from torchft_tpu_torch.chaos import kill_process

    subs = list(PAR_SIZES)
    t0 = time.perf_counter()
    tcp = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False,
                        timeout=datetime.timedelta(seconds=300))
    lighthouses = {s: tft.Lighthouse(min_replicas=PAR_GROUPS,
                                     join_timeout_ms=10000, quorum_tick_ms=50,
                                     heartbeat_timeout_ms=5000) for s in subs}
    stores = {s: {str(g): Store() for g in range(PAR_GROUPS)} for s in subs}
    base = {"role": "parallel", "workdir": workdir, "device": device,
            "sizes": sizes, "mesh_port": tcp.port, "subs": subs,
            "incarnation": 0, "seed": 0,
            "lighthouses": {s: lh.address() for s, lh in lighthouses.items()},
            "stores": {s: {g: st.address() for g, st in v.items()}
                       for s, v in stores.items()}}
    procs = []
    out: dict = {}
    restart_store = Store()
    probes, collect = ({}, None)
    try:
        procs = [_par_spawn({**base, "group": g, "rank": r}, workdir)
                 for g in range(PAR_GROUPS) for r in range(PAR_RANKS)]
        if device == "cuda":
            probes, collect = _gloo_verdicts(workdir, tcp.port, device)
        deadline = time.monotonic() + 600

        def timed_done() -> bool:
            return all(sum(1 for row in _par_rows(workdir, 1, r)
                           if row["committed"]) >= PAR_WARM + PAR_STEPS
                       for r in range(PAR_RANKS))

        while not timed_done():
            if any(p.poll() is not None for p in procs):
                _par_fail(procs, workdir, "a parallel worker exited early")
            if time.monotonic() > deadline:
                _par_fail(procs, workdir, "the parallel launch timed out")
            time.sleep(0.05)
        victims = procs[PAR_RANKS:]
        t_kill = time.time()
        for p in victims:
            kill_process(p.pid)
        for p in victims:
            p.wait(30)
        out["kill_t"] = t_kill
        restart = {**base, "subs": ["tp flash"], "incarnation": 1, "seed": 1,
                   "restart": True,
                   "stores": {**base["stores"], "tp flash": {
                       **base["stores"]["tp flash"],
                       "1": restart_store.address()}}}
        procs[PAR_RANKS:] = [_par_spawn({**restart, "group": 1, "rank": r},
                                        workdir) for r in range(PAR_RANKS)]
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                _par_fail(procs, workdir, "a parallel worker did not finish")
        if any(p.returncode != 0 for p in procs):
            _par_fail(procs, workdir, "a parallel worker failed")
        if collect is not None:
            out["gloo_verdicts"] = collect()
    finally:
        for p in procs + list(probes.values()):
            if p.poll() is None:
                p.kill()
        for lh in lighthouses.values():
            lh.shutdown()
        for v in stores.values():
            for st in v.values():
                st.shutdown()
        restart_store.shutdown()
    out["results"] = {}
    for name in sorted(os.listdir(workdir)):
        if name.startswith("par_") and name.endswith(".json"):
            with open(os.path.join(workdir, name)) as f:
                res = json.load(f)
            out["results"].setdefault(res["sub"], []).append(
                {**res, "incarnation": int(name[:-5].rsplit("_", 1)[1])})
    out["progress"] = {f"{g}_{r}": _par_rows(workdir, g, r)
                       for g in range(PAR_GROUPS) for r in range(PAR_RANKS)}
    out["total_s"] = time.perf_counter() - t0
    return out


def check_parallel(res: dict, on_card: bool = True) -> dict:
    """Per sub-phase: the step-0 loss of every rank within PAR_LOSS_RTOL of
    the unsharded loss, every warm-up and timed step committed, the
    groups' params bit-identical rank for rank after every step, and the
    kernels launched; in tp flash every rank of the restarted group healed
    over the stream once and ended bit-identical to group 0's same rank."""
    summary: dict = {}
    steps = PAR_WARM + PAR_STEPS
    for sub in PAR_SIZES:
        results = res["results"].get(sub, [])
        world = 1 if sub == "cnn" else PAR_RANKS
        first = {(x["group"], x["rank"]): x for x in results
                 if x["incarnation"] == 0}
        healed = {x["rank"]: x for x in results if x["incarnation"] == 1}
        want = PAR_GROUPS * world - (world if sub == "tp flash" else 0)
        if len(first) != want:
            fail(f"parallel {sub}: {len(first)} results, want {want}")
        ref = first[(0, 0)]["loss_unsharded"]
        rows = {}
        for g in range(PAR_GROUPS):
            for r in range(world):
                if (g, r) in first:
                    rows[(g, r)] = first[(g, r)]["rows"]
                else:  # tp flash's killed incarnation: its progress rows
                    pid = healed[r]["pid"]
                    rows[(g, r)] = [row for row in res["progress"][f"{g}_{r}"]
                                    if row["pid"] != pid]
        for r in range(world):
            for g in range(PAR_GROUPS):
                got = [row["committed"] for row in rows[(g, r)][:steps]]
                if got != [True] * steps:
                    fail(f"parallel {sub}: group {g} rank {r} commits {got}")
            for a, b in zip(rows[(0, r)][:steps], rows[(1, r)][:steps]):
                if a["checksum"] != b["checksum"]:
                    fail(f"parallel {sub}: rank {r}'s params part at step "
                         f"{a['step']}")
            loss0 = rows[(0, r)][0]["loss"]
            if loss0 is None or abs(loss0 - ref) > PAR_LOSS_RTOL * abs(ref):
                fail(f"parallel {sub}: rank {r}'s step-0 loss {loss0} vs the "
                     f"unsharded {ref}")
            last = healed[r] if sub == "tp flash" else first[(1, r)]
            if first[(0, r)]["digest"] != last["digest"]:
                fail(f"parallel {sub}: the groups' rank {r} ended apart")
        launches: dict = {}
        for x in results:
            for k, v in x["launches"].items():
                launches[k] = launches.get(k, 0) + v
        if on_card:
            for name in PAR_KERNELS[sub]:
                if launches.get(name, 0) == 0:
                    fail(f"parallel {sub}: {name} never launched")
        timed = [row for v in rows.values() for row in v[PAR_WARM:steps]]
        mesh_s: dict = {}
        for row in timed:
            for op, (calls, secs, nbytes) in row["mesh"].items():
                m = mesh_s.setdefault(op, [0, 0.0, 0])
                m[0] += calls
                m[1] += secs
                m[2] += nbytes
        n_timed = max(1, len(timed))
        keys = sorted(rows)
        summary[sub] = {
            "loss_unsharded": ref,
            "loss_step0": {f"{g}/{r}": rows[(g, r)][0]["loss"] for g, r in keys},
            "step_ms_p50": _p50([row["t"] - row["t0"] for row in timed]),
            "step_ms_all": [round(1e3 * (row["t"] - row["t0"]), 1)
                            for row in timed],
            "mesh_per_step": {op: {"calls": round(v[0] / n_timed, 1),
                                   "ms": round(1e3 * v[1] / n_timed, 1),
                                   "MB": round(v[2] / n_timed / 1e6, 1)}
                              for op, v in sorted(mesh_s.items())},
            "ring_by_rank": {f"{g}/{r}": {k: _median([
                row["ops"].get("plan_allreduce", {}).get(f"{k}_ms")
                for row in rows[(g, r)][PAR_WARM:steps]])
                for k in ("pack", "d2h", "ring")} for g, r in keys},
            "shard_params": {f"{g}/{r}": first[(g, r)]["shard_params"]
                             for g, r in sorted(first)},
            "max_memory_gb": {f"{g}/{r}": round(
                first[(g, r)].get("max_memory_allocated", 0) / 2**30, 2)
                for g, r in sorted(first)},
            "launches": launches,
        }
        if sub == "tp flash":
            if len(healed) != PAR_RANKS:
                fail(f"parallel tp flash: {len(healed)} restarted ranks")
            firsts = []
            for r, x in sorted(healed.items()):
                if x["fetch"] is None or x["fetch"].get("path") != "stream":
                    fail(f"parallel tp flash: rank {r} healed by {x['fetch']}")
                if max(row["heals"] for row in x["rows"]) != 1:
                    fail(f"parallel tp flash: rank {r} heals "
                         f"{[row['heals'] for row in x['rows']]}")
                c = [row["t"] for row in x["rows"] if row["committed"]]
                if not c:
                    fail(f"parallel tp flash: rank {r} never committed after "
                         f"the restart")
                firsts.append(min(c))
            summary[sub]["kill_to_first_commit_s"] = round(
                max(firsts) - res["kill_t"], 3)
            summary[sub]["heal_fetch"] = {r: {k: x["fetch"].get(k) for k in (
                "path", "fetch_s", "h2d_s", "bytes")}
                for r, x in sorted(healed.items())}
            summary[sub]["after_heal_commits"] = {
                r: [row["committed"] for row in x["rows"]]
                for r, x in sorted(healed.items())}
    return summary


def parallel_phases(by_phase: dict) -> None:
    """The model-parallel launch: runs, is checked and logged, and puts
    each sub-phase's launch counts into ``by_phase``."""
    _phase("parallel")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_par_") as workdir:
        res = phase_parallel(workdir)
        summary = check_parallel(res)
    log(f"  parallel launch {res['total_s']:.1f} s (two groups of two rank "
        f"processes, one card, gloo meshes; {PAR_WARM} warm-up + {PAR_STEPS} "
        f"timed blocking steps a sub-phase; card {_smi()})")
    for sub, row in summary.items():
        by_phase[f"parallel {sub}"] = row.pop("launches")
        log(f"  parallel {sub} {PAR_AXES[sub]}: {json.dumps(row)}")
    log(f"  gloo handed a card tensor directly (torch {torch.__version__}): "
        f"{json.dumps(res.get('gloo_verdicts'))}")


def _turns(tree_a: str, tree_b: str, code: str):
    """Runs ``code`` in checkouts a and b in turns (a, b, b, a), each turn
    a process of that checkout's own chip_smoke (its own build); yields
    (label, tree, seconds, the dict its ``TURN`` line printed, stdout)."""
    for label, tree in (("a", tree_a), ("b", tree_b), ("b", tree_b),
                        ("a", tree_a)):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=tree,
                              capture_output=True, text=True, timeout=1200)
        line = next((l for l in proc.stdout.splitlines()
                     if l.startswith("TURN ")), None)
        if proc.returncode != 0 or line is None:
            log(proc.stdout[-3000:] + proc.stderr[-3000:])
            fail(f"turn in {tree} exited {proc.returncode}")
        yield (label, tree, round(time.perf_counter() - t0, 1),
               json.loads(line[5:]), proc.stdout)


def legacy_turns(tree_a: str, tree_b: str) -> int:
    """The legacy and sharded flash phases of two checkouts in turns, one
    JSON line per turn: each legacy mode's step p50 and the sharded flash
    step p50 and all steps."""
    code = (
        "import json, tempfile, chip_smoke as cs\n"
        "cs.phase_build()\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    l = cs.check_legacy(cs.phase_legacy(d))\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    s = cs.check_sharded_flash(cs.phase_sharded_flash(d))\n"
        "print('TURN ' + json.dumps({'legacy': {m: {k: r[k] for k in "
        "('step_ms_p50', 'step_ms_all', 'blocking_ms')} for m, r in "
        "l['modes'].items()}, 'sharded': {k: s[k] for k in "
        "('step_ms_p50', 'step_ms_all')}}), flush=True)\n"
    )
    for label, tree, secs, turn, _ in _turns(tree_a, tree_b, code):
        print(json.dumps({"turn": label, "tree": tree, "s": secs, **turn}),
              flush=True)
    print(_smi(), flush=True)
    return 0


def kernel_turns(tree_a: str, tree_b: str) -> int:
    """The flash kernel phase of two checkouts in turns, one JSON line per
    turn (each flash kernel's ms, library ms, bound ms and error) after
    the turn's phase log, then K4's and K5's times by checkout, b's mean
    over a's and whether b was faster in every turn."""
    code = (
        "import json, chip_smoke as cs\n"
        "cs.phase_build()\n"
        "rows = cs.phase_flash_kernels()\n"
        "print('TURN ' + json.dumps({n: {k: r[k] for k in ('ms', "
        "'library_ms', 'bound_ms', 'max_abs_err')} for n, r in "
        "rows.items()}), flush=True)\n"
    )
    ms = {"k4": {"a": [], "b": []}, "k5": {"a": [], "b": []}}
    for label, tree, secs, turn, out in _turns(tree_a, tree_b, code):
        for l in out.splitlines():  # the phase's log, less ptxas
            if l.startswith("  ") and not l.startswith("  ptxas"):
                log(f"  [{label}]{l}")
        ms["k4"][label].append(turn["flash_fwd"]["ms"])
        ms["k5"][label].append(turn["flash_bwd"]["ms"])
        print(json.dumps({"turn": label, "tree": tree, "s": secs, **turn}),
              flush=True)
    for name, t in ms.items():
        print(json.dumps({f"{name}_ms": t,
                          "b_over_a": sum(t["b"]) / sum(t["a"]),
                          "b_faster_every_turn": max(t["b"]) < min(t["a"])}),
              flush=True)
    print(_smi(), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    parser.add_argument("--pooled", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--heal-donor", help=argparse.SUPPRESS)
    parser.add_argument("--control-worker", help=argparse.SUPPRESS)
    parser.add_argument("--flash-turns", action="store_true",
                        help="measure only: the flat q8 and the hier flash "
                        "phases in turns (flat, hier, hier, flat)")
    parser.add_argument("--shm-probe", action="store_true",
                        help="check only that /dev/shm takes the host tier")
    parser.add_argument("--start-probe", action="store_true",
                        help="measure only: a fresh process's start (import "
                        "torch, CUDA context, first flash pass)")
    parser.add_argument("--window-phases", action="store_true",
                        help="build, then run only the window-strategy and "
                        "AdaptiveDDP phases")
    parser.add_argument("--serving-phases", action="store_true",
                        help="build, then run only the durable flash, "
                        "serving flash and parameter server phases")
    parser.add_argument("--control-phases", action="store_true",
                        help="build, then run only the control dense, "
                        "chaos flash and policy flash phases")
    parser.add_argument("--iso-phases", action="store_true",
                        help="build, then run only the NCCL probe, xla "
                        "dense, iso flash and adaptive dense phases")
    parser.add_argument("--harness-phases", action="store_true",
                        help="build, then run only the chaos-invariant "
                        "harness phase (scripts/chaos_run_torch.py)")
    parser.add_argument("--quickstart-phases", action="store_true",
                        help="build, then run only the quickstart phase "
                        "(examples/train_ddp_torch.py under the launcher "
                        "with hot spares, a SIGKILL and a bf16 heal)")
    parser.add_argument("--experiments-phases", action="store_true",
                        help="build, then run only the experiments phase, "
                        "the four experiments/*_torch.py in full and "
                        "experiments/verify_e2e_torch.sh")
    parser.add_argument("--bench-phases", action="store_true",
                        help="build, then run only the bench phase, "
                        "bench_torch.py in full and the three "
                        "experiments that import it")
    parser.add_argument("--churn-phases", action="store_true",
                        help="build, then run only the churn phase, then "
                        "bench_churn_torch.py in full (4 groups, 1200 "
                        "steps, a kill every 100, hot spares) and "
                        "--durable")
    parser.add_argument("--parallel-phases", action="store_true",
                        help="build, then run only the model-parallel "
                        "launch (cnn, cp ulysses, cp ring, pp flash, ep moe, "
                        "tp flash with a kill and heal)")
    parser.add_argument("--legacy-turns", nargs=2, metavar=("TREE_A", "TREE_B"),
                        help="measure only: the legacy and sharded flash "
                        "phases of two checkouts in turns (a, b, b, a)")
    parser.add_argument("--kernel-turns", nargs=2, metavar=("TREE_A", "TREE_B"),
                        help="measure only: the flash kernel phase of two "
                        "checkouts in turns (a, b, b, a)")
    args = parser.parse_args()
    if args.pooled:
        return _pooled()
    if args.worker:
        worker(json.loads(args.worker))
        return 0
    if args.heal_donor:
        heal_donor(json.loads(args.heal_donor))
        return 0
    if args.control_worker:
        control_worker(json.loads(args.control_worker))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 1
    import torchft_tpu_torch  # noqa: F401 - fails outside a checkout

    t_start = time.perf_counter()
    if not (args.shm_probe or args.start_probe or args.legacy_turns
            or args.kernel_turns):
        global POOL
        POOL = _WarmPool(POOL_SIZE)
        atexit.register(POOL.close)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    if args.flash_turns:
        return flash_turns()
    if args.shm_probe:
        return shm_probe()
    if args.start_probe:
        return start_probe()
    if args.legacy_turns:
        return legacy_turns(*args.legacy_turns)
    if args.kernel_turns:
        return kernel_turns(*args.kernel_turns)
    if args.serving_phases:
        log(f"  built: {json.dumps({k: round(v, 2) for k, v in phase_build().items()})}")
        by_phase: dict = {}
        serving_phases(by_phase)
        log(f"  launches by phase: {json.dumps(by_phase)}")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(_smi(), flush=True)
        return 0
    if args.control_phases:
        log(f"  built: {json.dumps({k: round(v, 2) for k, v in phase_build().items()})}")
        by_phase = {}
        control_phases(by_phase)
        log(f"  launches by phase: {json.dumps(by_phase)}")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(_smi(), flush=True)
        return 0
    if args.iso_phases:
        log(f"  built: {json.dumps({k: round(v, 2) for k, v in phase_build().items()})}")
        by_phase = {}
        iso_phases(by_phase)
        log(f"  launches by phase: {json.dumps(by_phase)}")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(_smi(), flush=True)
        return 0
    if args.harness_phases:
        log(f"  built: {json.dumps({k: round(v, 2) for k, v in phase_build().items()})}")
        by_phase = {}
        harness_phases(by_phase)
        log(f"  launches by phase: {json.dumps(by_phase)}")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"phase_s": _phase_seconds()}), flush=True)
        print(_smi(), flush=True)
        return 0
    if args.quickstart_phases:
        log(f"  built: {json.dumps({k: round(v, 2) for k, v in phase_build().items()})}")
        by_phase = {}
        quickstart_phases(by_phase)
        log(f"  launches by phase: {json.dumps(by_phase)}")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"phase_s": _phase_seconds()}), flush=True)
        print(_smi(), flush=True)
        return 0
    if args.experiments_phases:
        log(f"  built: {json.dumps({k: round(v, 2) for k, v in phase_build().items()})}")
        by_phase = {}
        experiments_phases(by_phase)
        log(f"  launches by phase: {json.dumps(by_phase)}")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"phase_s": _phase_seconds()}), flush=True)
        print(_smi(), flush=True)
        return 0
    if args.bench_phases:
        log(f"  built: {json.dumps({k: round(v, 2) for k, v in phase_build().items()})}")
        by_phase = {}
        bench_phases(by_phase)
        log(f"  launches by phase: {json.dumps(by_phase)}")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"phase_s": _phase_seconds()}), flush=True)
        print(_smi(), flush=True)
        return 0
    if args.churn_phases:
        log(f"  built: {json.dumps({k: round(v, 2) for k, v in phase_build().items()})}")
        by_phase = {}
        churn_phases(by_phase)
        log(f"  launches by phase: {json.dumps(by_phase)}")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"phase_s": _phase_seconds()}), flush=True)
        print(_smi(), flush=True)
        return 0
    if args.parallel_phases:
        log(f"  built: {json.dumps({k: round(v, 2) for k, v in phase_build().items()})}")
        by_phase = {}
        parallel_phases(by_phase)
        log(f"  launches by phase: {json.dumps(by_phase)}")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"phase_s": _phase_seconds()}), flush=True)
        print(_smi(), flush=True)
        return 0
    if args.window_phases:
        log(f"  built: {json.dumps({k: round(v, 2) for k, v in phase_build().items()})}")
        window_phases({})
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(_smi(), flush=True)
        return 0
    _phase("build")
    log(f"  built: {json.dumps({k: round(v, 2) for k, v in phase_build().items()})}")
    _phase("kernels")
    rows = phase_kernels()
    _phase("flash kernels")
    rows.update(phase_flash_kernels())
    torch.cuda.empty_cache()  # the card's memory goes to the workers next
    by_phase: dict = {}  # each main-path phase's launch counts
    _phase("train + heal")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        res = phase_train_and_heal(workdir)
        summary = check_training(res)
    by_phase["train + heal"] = summary["launches"]
    log(f"  train phase {res['train_s']:.1f} s, train+heal {res['total_s']:.1f} s; "
        f"q8 step p50 {summary['step_ms_p50']:.3f} ms over the steady steps "
        f"(all: {summary['step_ms_all']}); whole timed window "
        f"{summary['window_ms_per_step']} ms/step per founder; "
        f"forward/backward alone {summary['compute_ms']} ms per founder; "
        f"heal fetch {summary['heal_fetch_s']:.3f} s")
    log(f"  warm-up steps (not timed) {summary['warm_step_ms']} ms per founder; "
        f"group 0 transaction timers over them, ms: {summary['warm_timers_ms']}")
    log(f"  group 0 transaction timers over the timed steps, ms: "
        f"{summary['q8_timers_ms']}")
    log(f"  trace of group 0's {TRACED_STEPS} traced steps (card clock): "
        f"{json.dumps(summary['trace'])}")
    _log_ring_split("dense", summary)
    _phase("flash train")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_flash_") as workdir:
        fres = phase_flash_train(workdir)
        fsum = check_flash_training(fres)
    by_phase["flash train"] = fsum["launches"]
    log(f"  flash train {fres['total_s']:.1f} s; step p50 "
        f"{fsum['step_ms_p50']:.3f} ms over the steady steps (all: "
        f"{fsum['step_ms_all']}); whole timed window "
        f"{fsum['window_ms_per_step']} ms/step per founder; plan_allreduce "
        f"mean {fsum['plan_allreduce_ms']} ms (group 0); forward/backward "
        f"alone {fsum['compute_ms']} ms per founder; "
        f"max_memory_allocated {fsum['max_memory_allocated_gb']} GiB per "
        f"group, allocated at each timed step's start "
        f"{fsum['step_start_allocated_gb']} GiB; flash vs dense loss {json.dumps(fsum['flash_vs_dense'])}")
    log(f"  group 0 transaction timers over the timed flash steps, ms: "
        f"{fsum['timers_ms']}")
    log(f"  trace of group 0's {TRACED_FLASH_STEPS} traced flash steps (card "
        f"clock): {json.dumps(fsum['trace'])}")
    _log_ring_split("flash", fsum)
    _phase("hier flash train")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hier_") as workdir:
        hres = phase_flash_train(workdir, hier=True)
        hsum = check_flash_training(hres, hier=True)
    by_phase["hier flash train"] = hsum["launches"]
    log(f"  hier flash train {hres['total_s']:.1f} s (two co-hosted groups, "
        f"PipelinedDDP(compress='q8', hier=True): one region, so no inter "
        f"hop and no q8: the f32 average over the shm host tier, another "
        f"schedule than the flat q8 ring, not a faster copy of it); "
        f"topology {json.dumps(hsum['topology'])}; step p50 "
        f"{hsum['step_ms_p50']:.3f} ms (all: {hsum['step_ms_all']}); whole "
        f"timed window {hsum['window_ms_per_step']} ms/step per group; "
        f"plan_allreduce mean {hsum['plan_allreduce_ms']} ms (group 0); "
        f"max_memory_allocated {hsum['max_memory_allocated_gb']} GiB")
    log(f"  tier split of the hier flash cell (group 0, median over the timed "
        f"steps): {json.dumps(hsum['ring_split'])}; tier_eff_MBps "
        f"{json.dumps(hsum['signals']['tier_eff_MBps'])}")
    log(f"  trace of group 0's {TRACED_FLASH_STEPS} traced hier flash steps "
        f"(card clock): {json.dumps(hsum['trace'])}")
    _phase("hier dense")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hdense_") as workdir:
        dres = phase_hier_dense(workdir)
        dsum = check_hier_dense(dres)
    by_phase["hier dense"] = {}
    log(f"  hier dense {dres['total_s']:.1f} s, four groups bit-identical; "
        f"whole timed window {dsum['window_ms_per_step']} ms/step per group; "
        f"tier_eff_MBps {json.dumps(dsum['signals']['tier_eff_MBps'])}; per "
        f"group (median over the timed steps): {json.dumps(dsum['split'])}")
    _phase("legacy")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_legacy_") as workdir:
        lres = phase_legacy(workdir)
        lsum = check_legacy(lres)
    by_phase["legacy"] = lsum["launches"]
    log(f"  legacy {lres['total_s']:.1f} s, two groups on the dense LM, every "
        f"step committed, parameters bit-identical after every mode; "
        f"broadcast/barrier/DummyCollectives {json.dumps(lsum['plane_ops'])}")
    for mode, row in lsum["modes"].items():
        log(f"  legacy {mode}: step p50 {row['step_ms_p50']:.3f} ms (steady "
            f"pipelined steps of both groups: {row['step_ms_all']}), blocking "
            f"{row['blocking_ms']} ms; launches {json.dumps(row['launches'])}; "
            f"op split (group 0, medians) {json.dumps(row['ops'])}"
            + (f"; ring split {json.dumps(row['ring_split'])}"
               if "ring_split" in row else ""))
    _phase("sharded flash")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as workdir:
        sres = phase_sharded_flash(workdir)
        ssum = check_sharded_flash(sres)
    by_phase["sharded flash"] = ssum["launches"]
    log(f"  sharded flash {sres['total_s']:.1f} s (ShardedDDP, shard_wire q8, "
        f"param_wire bf16, two groups, {SHARDED_WARM} warm-up + "
        f"{SHARDED_STEPS} steps): step p50 {ssum['step_ms_p50']:.3f} ms (all: "
        f"{ssum['step_ms_all']}); opt_state_bytes {ssum['opt_state_bytes']} "
        f"of {FLASH_ADAMW_BYTES} B for the full AdamW state; "
        f"max_memory_allocated {ssum['max_memory_allocated_gb']} GiB per group "
        f"against the flat flash cell's {fsum['max_memory_allocated_gb']} GiB; "
        f"launches {json.dumps(ssum['launches'])}")
    log(f"  sharded flash op split (group 0, medians over the timed steps): "
        f"{json.dumps(ssum['ops'])}; timers ms {json.dumps(ssum['timers_ms'])}")
    _phase("sharded reshard")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_reshard_") as workdir:
        rsres = phase_reshard(workdir)
        rssum = check_reshard(rsres)
    log(f"  sharded reshard {rsres['total_s']:.1f} s: commits per group "
        f"{rssum['commits']}, the joiner healed {json.dumps(rssum['fetch'])}; "
        f"opt_state_bytes after the reshard {rssum['opt_state_bytes']}; "
        f"three groups bit-identical, shards tile the model; op split "
        f"{json.dumps(rssum['ops'])}")
    _phase("heal transport")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_heal_") as workdir:
        hres = phase_heal_transport(workdir)
        check_heal_transport(hres)
    by_phase["heal transport"] = hres["launches"]
    log(f"  heal transport at the flash LM's state (111,166,464 params + mu + "
        f"nu, f32 on the card; donor process -> this process): "
        f"{json.dumps(hres['fetches'])}; donor launches {hres['launches']}, "
        f"staging build (pinned buffer, d2h, K3) s by wire "
        f"{json.dumps(hres['staging_build_s'])}; CRC32C of the raw staging "
        f"{hres['crc_s']:.4f} s")
    _phase("remat")
    rres = phase_remat()
    rsum = check_remat(rres)
    by_phase["remat"] = rsum["launches"]
    log(f"  remat on the flash LM (B{BIG_BATCH}, S{BIG_SEQ - 1}, bf16), one "
        f"forward+backward each: {json.dumps(rres['rows'])}")
    torch.cuda.empty_cache()  # the card's memory goes to the workers next
    experiments_phase(by_phase)
    bench_phase(by_phase)
    torch.cuda.empty_cache()
    churn_phase(by_phase)
    torch.cuda.empty_cache()
    window_phases(by_phase)
    torch.cuda.empty_cache()
    serving_phases(by_phase)
    torch.cuda.empty_cache()
    control_phases(by_phase, harness=True)
    torch.cuda.empty_cache()
    iso_phases(by_phase, flash_step_ms=fsum["step_ms_p50"])
    torch.cuda.empty_cache()
    parallel_phases(by_phase)
    torch.cuda.empty_cache()
    quickstart_phases(by_phase)
    # each kernel's launches over the main paths' runs (the counts each
    # worker, or phase, reset just before a path and read just after)
    for name in rows:
        rows[name]["launches_by_phase"] = {
            phase: counts.get(name, 0) for phase, counts in by_phase.items()}
        rows[name]["launches"] = sum(rows[name]["launches_by_phase"].values())
    for name in ("q8_absmax", "q8_quantize", "q8_dequantize", "cast_bf16",
                 "flash_fwd", "flash_bwd"):
        if rows[name]["launches"] == 0:
            fail(f"{name} is on a main path and never launched there")
    for name in ("flash_fwd", "flash_bwd"):
        for phase in ("hier flash train", "sharded flash"):
            if rows[name]["launches_by_phase"][phase] == 0:
                fail(f"{name} never launched on the {phase} path")
    for name in ("q8_absmax", "q8_quantize", "q8_dequantize", "cast_bf16"):
        if rows[name]["launches_by_phase"]["legacy"] == 0:
            fail(f"{name} never launched on the legacy transport")
    if rows["cast_bf16"]["launches_by_phase"]["heal transport"] == 0:
        fail("cast_bf16 never launched on the bf16 heal wire")
    for phase, names in (
            ("async diloco flash", ("q8_absmax", "q8_quantize",
                                    "q8_dequantize", "cast_bf16",
                                    "flash_fwd", "flash_bwd")),
            ("sharded diloco", ("q8_absmax", "q8_quantize", "q8_dequantize",
                                "cast_bf16", "flash_fwd", "flash_bwd")),
            ("diloco reshard", ("q8_absmax", "q8_quantize", "q8_dequantize",
                                "cast_bf16")),
            ("adaptive flash", ("q8_absmax", "q8_quantize", "q8_dequantize",
                                "flash_fwd", "flash_bwd")),
            ("durable flash", ("cast_bf16",)),
            ("serving flash", ("q8_absmax", "q8_quantize", "q8_dequantize",
                               "cast_bf16")),
            ("parameter server", ("q8_absmax", "q8_quantize",
                                  "q8_dequantize")),
            ("control dense", ("q8_absmax", "q8_quantize", "cast_bf16")),
            ("chaos flash", ("q8_absmax", "q8_quantize", "flash_fwd",
                             "flash_bwd")),
            ("policy flash", ("q8_absmax", "q8_quantize", "q8_dequantize",
                              "flash_fwd", "flash_bwd")),
            ("chaos harness", ("q8_absmax", "q8_quantize", "q8_dequantize")),
            ("xla dense", ("q8_absmax", "q8_quantize", "q8_dequantize")),
            ("iso flash", ("q8_absmax", "q8_quantize", "q8_dequantize",
                           "flash_fwd", "flash_bwd")),
            ("adaptive dense", ("q8_absmax", "q8_quantize",
                                "q8_dequantize")),
            ("quickstart", ("cast_bf16",)),
            ("experiments", ("flash_fwd", "flash_bwd")),
            ("bench", ("q8_absmax", "q8_quantize", "q8_dequantize",
                       "cast_bf16", "flash_fwd", "flash_bwd")),
            ("churn", ("cast_bf16",)),
            ("churn durable", ("cast_bf16",)),
            *((f"parallel {sub}", names) for sub, names in PAR_KERNELS.items())):
        for name in names:
            if rows[name]["launches_by_phase"][phase] == 0:
                fail(f"{name} never launched on the {phase} path")
    log(f"  worker starts through the pool: {POOL.warm} warm, {POOL.cold} "
        f"cold (none idle)")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"phase_s": _phase_seconds()}), flush=True)
    print(_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

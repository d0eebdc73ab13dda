#!/bin/bash
# E2E verify of the port: the lighthouse CLI and its dashboard, then two
# replica groups of examples/train_ddp_torch.py with a mid-run SIGKILL of
# group 1, its restart and a live heal from group 0. The port's
# counterpart of verify_e2e.sh.
#
#   bash experiments/verify_e2e_torch.sh                    # on the card
#   DEVICE=cpu NUM_STEPS=3000 bash experiments/verify_e2e_torch.sh
#
# DEVICE passes through to the trainers (the card unless DEVICE=cpu);
# NUM_STEPS defaults to verify_e2e.sh's 20000: the demo MLP runs fast, so
# the step count must leave the kill, the restart (interpreter + torch
# import) and the heal room to land while group 0 still trains. Logs go to
# WORKDIR (default: a new temporary directory); the lighthouse takes a free
# port unless LH_PORT names one. Every process started here is stopped on
# exit.
set -euo pipefail
cd "$(dirname "$0")/.."
export NUM_STEPS=${NUM_STEPS:-20000} NUM_REPLICA_GROUPS=2
WORKDIR=${WORKDIR:-$(mktemp -d)}
mkdir -p "$WORKDIR"
LH_PORT=${LH_PORT:-$(python -c 'import socket; s = socket.socket(); s.bind(("", 0)); print(s.getsockname()[1])')}
PIDS=()
cleanup() {
    for pid in "${PIDS[@]}"; do
        kill -9 "$pid" 2>/dev/null || true
    done
}
trap cleanup EXIT
fetch() {  # prints the body of a GET on the lighthouse
    python -c 'import sys, urllib.request; print(urllib.request.urlopen(sys.argv[1], timeout=10).read().decode())' "$1"
}
# a trainer's log line, waited for (a trainer that died stops the wait)
wait_for() {  # log pattern seconds pid
    for _ in $(seq 1 "$3"); do
        grep -q "$2" "$1" && return 0
        kill -0 "$4" 2>/dev/null || break
        sleep 1
    done
    grep -q "$2" "$1" || { echo "no '$2' in $1:"; tail -30 "$1"; exit 1; }
}
set -x

python -m torchft_tpu_torch.lighthouse --bind "[::]:$LH_PORT" --min_replicas 1 \
    --join_timeout_ms 2000 --quorum_tick_ms 50 --heartbeat_timeout_ms 1000 \
    > "$WORKDIR/lh.log" 2>&1 &
PIDS+=($!)
export TORCHFT_LIGHTHOUSE=http://localhost:$LH_PORT
for _ in $(seq 1 30); do
    fetch "$TORCHFT_LIGHTHOUSE/" > "$WORKDIR/dashboard.html" 2>/dev/null && break
    sleep 1
done
grep -qi torchft "$WORKDIR/dashboard.html"
fetch "$TORCHFT_LIGHTHOUSE/status" > "$WORKDIR/status0.html"

REPLICA_GROUP_ID=0 python examples/train_ddp_torch.py > "$WORKDIR/g0.log" 2>&1 &
G0=$!
PIDS+=($G0)
REPLICA_GROUP_ID=1 python examples/train_ddp_torch.py > "$WORKDIR/g1.log" 2>&1 &
G1=$!
PIDS+=($G1)

# wait until group 1 is actually training, then SIGKILL it and restart
wait_for "$WORKDIR/g1.log" "step=200" 300 "$G1"
kill -9 "$G1" || true
REPLICA_GROUP_ID=1 python examples/train_ddp_torch.py > "$WORKDIR/g1b.log" 2>&1 &
G1B=$!
PIDS+=($G1B)

RC0=0; wait "$G0" || RC0=$?
RC1=0; wait "$G1B" || RC1=$?
test "$RC0" -eq 0
test "$RC1" -eq 0
grep -q "done: step=$NUM_STEPS" "$WORKDIR/g0.log"
grep -q "done: step=$NUM_STEPS" "$WORKDIR/g1b.log"
# the restarted group healed live from the surviving peer
grep -q "healing from" "$WORKDIR/g1b.log"
set +x
echo "E2E VERIFY OK (logs in $WORKDIR)"

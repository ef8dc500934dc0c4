#!/usr/bin/env bash
# One-command localhost federation of tpuvdb_torch processes: a coordinator
# + N data nodes, registered and health-checked. The port of
# scripts/start_cluster.sh.
#
#   start_cluster.sh [N_NODES]       start + register (default 3)
#   start_cluster.sh demo            start, ingest, kill a node, prove
#                                    failover, clean up
#   start_cluster.sh stop            stop everything
#
# Env: TPUVDB_CLUSTER_DIR (default ./cluster_run), TPUVDB_COORD_PORT
# (default 8081), TPUVDB_NODE_BASE_PORT (default 9090: node i on 9090 + i),
# TPUVDB_DEVICE (default cuda: every node and the coordinator run on the
# card, several processes sharing it; cpu runs the kernels' plain PyTorch
# versions), TPUVDB_PYTHON (default python3). A process that does not come
# up stops the cluster and exits non-zero; nothing retries on another
# device.
set -euo pipefail

DIR="${TPUVDB_CLUSTER_DIR:-./cluster_run}"
COORD_PORT="${TPUVDB_COORD_PORT:-8081}"
BASE_PORT="${TPUVDB_NODE_BASE_PORT:-9090}"
DEVICE="${TPUVDB_DEVICE:-cuda}"
PY="${TPUVDB_PYTHON:-python3}"
CLI="$PY -m tpuvdb_torch.api.cli"

wait_healthy() { # host:port
  for _ in $(seq 1 60); do
    curl -sf "http://$1/healthz" >/dev/null 2>&1 && return 0
    sleep 0.5
  done
  echo "node $1 failed to come up" >&2
  return 1
}

stop_all() {
  local p
  for p in "$DIR"/pids/*.pid; do
    [[ -f "$p" ]] || continue
    kill "$(cat "$p")" 2>/dev/null || true
    rm -f "$p"
  done
  echo "cluster stopped"
}

port_free() { # port — a server already answering /healthz means a STALE
  # cluster would silently absorb this run's registrations and ingest
  ! curl -sf "http://127.0.0.1:$1/healthz" >/dev/null 2>&1
}

start_cluster() {
  local n="$1"
  port_free "$COORD_PORT" || {
    echo "port $COORD_PORT already serving — stop the old cluster first" \
         "(start_cluster.sh stop)" >&2; exit 1; }
  for i in $(seq 0 $((n - 1))); do
    port_free $((BASE_PORT + i)) || {
      echo "port $((BASE_PORT + i)) already serving — stop the old" \
           "cluster first" >&2; exit 1; }
  done
  mkdir -p "$DIR"/pids "$DIR"/logs "$DIR"/coord
  # coordinator first (durable registry: restarts resume routing)
  nohup $CLI --device "$DEVICE" coordinate --port "$COORD_PORT" \
    --data-dir "$DIR/coord" >"$DIR/logs/coordinator.log" 2>&1 &
  echo $! > "$DIR/pids/coordinator.pid"
  wait_healthy "127.0.0.1:$COORD_PORT" || { stop_all; exit 1; }
  echo "coordinator on :$COORD_PORT"
  # data nodes (reference port scheme: 9090 + i)
  for i in $(seq 0 $((n - 1))); do
    local port=$((BASE_PORT + i))
    mkdir -p "$DIR/node$i"
    nohup $CLI serve --port "$port" --data-dir "$DIR/node$i" \
      --device "$DEVICE" >"$DIR/logs/node$i.log" 2>&1 &
    echo $! > "$DIR/pids/node$i.pid"
  done
  for i in $(seq 0 $((n - 1))); do
    wait_healthy "127.0.0.1:$((BASE_PORT + i))" || { stop_all; exit 1; }
    # register with the coordinator (register_node.sh -> CLI)
    $CLI --coord-addr "127.0.0.1:$COORD_PORT" register-node \
      "node$i" "127.0.0.1:$((BASE_PORT + i))" >/dev/null
    echo "node$i on :$((BASE_PORT + i)) registered"
  done
  $CLI --coord-addr "127.0.0.1:$COORD_PORT" list-nodes
}

vec() { # seed -> 512 seeded gaussians, comma-separated
  "$PY" -c "import random;random.seed($1);print(','.join(f'{random.gauss(0,1):.4f}' for _ in range(512)))"
}

demo() {
  start_cluster 3
  local addr="127.0.0.1:$COORD_PORT"
  echo "--- ingesting 8 vectors through the coordinator"
  for i in $(seq 0 7); do
    $CLI --coord-addr "$addr" put -- "key$i" "$(vec "$i")" >/dev/null
  done
  echo "--- search works (top-1 should be key3)"
  q=$(vec 3)
  $CLI --coord-addr "$addr" search -k 1 -- "$q"
  echo "--- killing node0"
  kill "$(cat "$DIR/pids/node0.pid")" && rm -f "$DIR/pids/node0.pid"
  sleep 7  # health loop marks it offline (5 s probe interval)
  echo "--- every key must still be readable (replica failover)"
  ok=1
  for i in $(seq 0 7); do
    $CLI --coord-addr "$addr" get -- "key$i" >/dev/null || ok=0
  done
  [[ "$ok" == 1 ]] && echo "FAILOVER OK: all 8 keys served with node0 dead" \
                   || echo "FAILOVER FAILED" >&2
  $CLI --coord-addr "$addr" search -k 1 -- "$q"
  stop_all
  [[ "$ok" == 1 ]]
}

case "${1:-3}" in
  stop) stop_all ;;
  demo) demo ;;
  *)    start_cluster "${1:-3}" ;;
esac

#!/usr/bin/env bash
# Start the tpuvdb_torch server in the background with a pidfile + liveness
# check: the port of scripts/start_server.sh. One process serves both roles,
# the coordinator surface and every shard (the mesh is the cluster), on
# TPUVDB_DEVICE (default cuda, the card; cpu runs the kernels' plain
# PyTorch versions). A server that does not come up exits non-zero;
# nothing retries on another device.
set -euo pipefail

HOST="${TPUVDB_HOST:-127.0.0.1}"
PORT="${TPUVDB_PORT:-8081}"
DATA_DIR="${TPUVDB_DATA_DIR:-./data}"
RUN_DIR="${TPUVDB_RUN_DIR:-./run}"
DEVICE="${TPUVDB_DEVICE:-cuda}"
PY="${TPUVDB_PYTHON:-python3}"
LOG_FILE="$RUN_DIR/server.log"
PID_FILE="$RUN_DIR/server.pid"

mkdir -p "$RUN_DIR" "$DATA_DIR"

if [[ -f "$PID_FILE" ]] && kill -0 "$(cat "$PID_FILE")" 2>/dev/null; then
  echo "tpuvdb_torch already running (pid $(cat "$PID_FILE"))"
  exit 0
fi

nohup "$PY" -m tpuvdb_torch.api.cli serve \
  --host "$HOST" --port "$PORT" --data-dir "$DATA_DIR" --device "$DEVICE" \
  >>"$LOG_FILE" 2>&1 &
echo $! > "$PID_FILE"

# liveness: poll the health endpoint
for _ in $(seq 1 30); do
  if curl -sf "http://$HOST:$PORT/healthz" >/dev/null 2>&1; then
    echo "tpuvdb_torch serving on http://$HOST:$PORT (pid $(cat "$PID_FILE"))"
    exit 0
  fi
  sleep 1
done
echo "server failed to come up; see $LOG_FILE" >&2
exit 1

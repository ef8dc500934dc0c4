#!/usr/bin/env bash
# Stop the tpuvdb_torch server: the port of scripts/stop_server.sh.
set -euo pipefail

RUN_DIR="${TPUVDB_RUN_DIR:-./run}"
PID_FILE="$RUN_DIR/server.pid"

if [[ -f "$PID_FILE" ]]; then
  PID="$(cat "$PID_FILE")"
  if kill -0 "$PID" 2>/dev/null; then
    kill "$PID"
    for _ in $(seq 1 20); do
      kill -0 "$PID" 2>/dev/null || break
      sleep 0.5
    done
    kill -0 "$PID" 2>/dev/null && kill -9 "$PID" || true
    echo "stopped pid $PID"
  else
    echo "stale pidfile (pid $PID not running)"
  fi
  rm -f "$PID_FILE"
else
  echo "no pidfile at $PID_FILE"
fi

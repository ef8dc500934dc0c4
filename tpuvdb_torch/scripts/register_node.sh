#!/usr/bin/env bash
# Register an external serving node with the coordinator: the port of
# scripts/register_node.sh.
set -euo pipefail

COORD="${TPUVDB_COORD:-127.0.0.1:8081}"
PY="${TPUVDB_PYTHON:-python3}"
NODE_ID="${1:?usage: register_node.sh NODE_ID ADDRESS}"
ADDRESS="${2:?usage: register_node.sh NODE_ID ADDRESS}"

"$PY" -m tpuvdb_torch.api.cli --coord-addr "$COORD" register-node \
  "$NODE_ID" "$ADDRESS"

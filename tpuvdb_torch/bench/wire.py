"""Bulk transfer on the binary wire against JSON: the port of
scripts/bench_wire.py.

    python -m tpuvdb_torch.bench.wire [--rows 100000] [--dim 512]
        [--device cuda]

Times the paginated export RPC, the data plane under backups, rejoin sync
and rebalance, against one in-process data node (`DBService` behind a
`DBServer`) over real HTTP, with the client speaking (a) JSON and (b) the
binary wire (core/wire.py: a msgpack envelope with raw f32 vector planes):
a warm-up export of pages of 500, then a timed export of pages of 2,000.
Also times a two-node `FederatedCoordinator.sync_all` (export one side,
replicate-push the other; both directions ride the same wire) and its
peak of records held at once. The engines run on --device (the export is
host-bound either way). Diagnostics go to stderr, and stdout takes one
JSON line with the reference's keys.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np

INGEST_BLOCK = 8192  # rows a put_rows call
PAGE = 2000          # records an export page
WARM_PAGE = 500      # records a page of the warm-up export


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def export_all(client, limit: int = PAGE) -> int:
    """Pages through the node's export RPC; the records it returned."""
    n = 0
    cursor = 0
    while cursor >= 0:
        r = client.call("export", {"cursor": cursor, "limit": limit})
        if not r["success"]:
            raise RuntimeError(f"export at cursor {cursor}: {r}")
        n += len(r["records"])
        cursor = int(r.get("cursor", -1))
    return n


def main(argv=None, device: Optional[str] = None) -> dict:
    """Prints the result line and returns it."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tpuvdb_torch.api.client import DBClient
    from tpuvdb_torch.api.server import DBServer
    from tpuvdb_torch.api.service import DBService
    from tpuvdb_torch.cluster.federation import FederatedCoordinator
    from tpuvdb_torch.core.config import DBConfig
    from tpuvdb_torch.device import resolve_device

    dev = resolve_device(device or args.device)

    def cfg():
        return DBConfig(vector_dim=args.dim, shard_count=4,
                        replica_count=1, shard_capacity=args.rows + 4096,
                        block_size=4096, wal_enabled=False,
                        rebalance_debounce_s=0,
                        checkpoint_every_puts=10 ** 12,
                        compact_every_puts=10 ** 12)

    rng = np.random.default_rng(0)
    svc = DBService(cfg(), device=dev)
    srv = DBServer(svc, port=0)
    srv.start_background()
    srv2 = coord = None
    try:
        log(f"ingesting {args.rows} x {args.dim} on {dev} ...")
        for lo in range(0, args.rows, INGEST_BLOCK):
            hi = min(lo + INGEST_BLOCK, args.rows)
            r = svc.engine.put_rows(
                [f"k{i}" for i in range(lo, hi)],
                rng.standard_normal((hi - lo, args.dim)).astype(np.float32))
            if not r.success:
                raise RuntimeError(f"put_rows [{lo}, {hi}): {r.message}")
        payload_mb = args.rows * args.dim * 4 / 1e6

        out = {"metric": "wire_bulk_transfer", "rows": args.rows,
               "dim": args.dim, "payload_mb": round(payload_mb, 1)}
        for name, binary in (("json", False), ("binary", True)):
            c = DBClient(srv.address, timeout=300, binary=binary)
            export_all(c, limit=WARM_PAGE)  # warm connection + code paths
            t0 = time.perf_counter()
            n = export_all(c)
            dt = time.perf_counter() - t0
            if n != args.rows:
                raise AssertionError(f"the {name} export returned {n} "
                                     f"records of {args.rows}")
            out[f"export_{name}_s"] = round(dt, 2)
            out[f"export_{name}_mb_s"] = round(payload_mb / dt, 1)
            log(f"export {name:>6}: {dt:7.2f} s  "
                f"({payload_mb / dt:8.1f} MB/s of vector payload)")
        out["export_speedup"] = round(
            out["export_json_s"] / out["export_binary_s"], 2)

        # sync_all between two nodes through a coordinator
        srv2 = DBServer(DBService(cfg(), device=dev), port=0)
        srv2.start_background()
        coord = FederatedCoordinator(cfg(), device=dev)
        coord.register_node("n0", srv.address)
        coord.register_node("n1", srv2.address)
        t0 = time.perf_counter()
        r = coord.sync_all()
        dt = time.perf_counter() - t0
        if not r.success:
            raise RuntimeError(f"sync_all: {r.message}")
        out["sync_all_2node_s"] = round(dt, 2)
        out["sync_all_peak_records"] = coord._sync_peak_records
        log(f"sync_all (binary wire, 2 nodes): {dt:.2f} s; "
            f"peak held records {coord._sync_peak_records}; {r.message}")
    finally:
        if coord is not None:
            coord.close()
        for server in (srv, srv2):
            if server is not None:
                server.shutdown()
                server.service.close()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

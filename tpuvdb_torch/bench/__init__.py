"""Benchmarks: the port of tpuvdb.bench. Import the modules themselves:
`harness` (`chained_timer`), `datasets`, `recall`, `scan` (the headline
scan QPS, `bench --suite scan`), `engine_serving` (the served path it
calls), `streaming` (durable ingest, `bench --suite streaming`),
`clip_e2e` (text -> image, `bench --suite clip`), `latency` (the
service's host-inclusive latency), `capacity` (the raw int8 scan at
8M x 768, and the helpers the capacity benches share), `capacity_engine`,
`capacity_ivf` and `capacity_pq` (the engine, IVF and IVF-PQ at
capacity), `wire` (bulk export on the binary wire against JSON, and a
two-node sync), `serving_ab` (search coalescing off against on),
`diag_pq_recall` (the IVF-PQ recall grid on capacity_pq's kept data dir)
and `diag_ivf_b1` (a b1 IVF probe's fixed cost, stage by stage); these
run with `python -m tpuvdb_torch.bench.<name>`."""

"""Benchmarks: the port of tpuvdb.bench. Import the modules themselves:
`harness` (`chained_timer`), `datasets`, `recall`, `scan` (the headline
scan QPS, `bench --suite scan`), `engine_serving` (the served path it
calls), `streaming` (durable ingest, `bench --suite streaming`) and
`clip_e2e` (text -> image, `bench --suite clip`)."""

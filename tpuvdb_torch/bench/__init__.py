"""Benchmark helpers: the port of tpuvdb.bench (the part the CLIP
benchmark stands on; the scan, serving and streaming benchmarks wait for
ROADMAP.md item 13). Import the modules themselves: `harness`
(`chained_timer`), `datasets`, `recall` and `clip_e2e`."""

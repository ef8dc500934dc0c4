"""Smoke run of the PyTorch/CUDA port (tpuvdb_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

It runs every phase, in this order; any failure exits non-zero, and nothing
is caught and carried on. The kernels (csrc/scan.cu; csrc/ivf_probe.cu, one
tensor-core probe template for f32, bf16 and int8 cells; csrc/pq_probe.cu
with the IVF-PQ ADC probe) are built first with nvcc for sm_90a, one nvcc
per source, side by side: three libraries. Their registers and spills
(nvcc -Xptxas -v) and, where cuobjdump is installed, each library's count
of tensor-core instructions (HGMMA for bf16 / tf32, IGMMA for s8) and TMA
loads (UTMALDG) are printed. Beside them g++ builds the native host runtime
(tpuvdb_torch/native: the C++ doc store, the group-commit WAL writer, the
mmap vector file, the fused exact rescore, and the fastlist extension);
its compile time is printed with the vectorizer's report on the rescore's
two dot loops (one more compile with -fopt-info-vec-all into a temp dir,
logged, not asserted).

Every engine runs on the native runtime: each timed engine, restart and
durability engine must show in info() the native doc store, fastlist and
the native rescore, and, with a data_dir, the native WAL writer.

  kernel      Holds the scan
              kernel against its plain PyTorch version on 1,048,576 x 512
              corpora in f32 and bf16 (about 1% dead rows), at Q = 1, 64
              and 256, plus a ragged N. Candidate rows must agree in >= 99.9%
              of (query, bucket) slots and every candidate score within
              rtol 1e-5 + atol 1e-3 (rows differ only at near-ties); the
              top-10 distances within rtol 1e-5. The same checks run on
              70,001-row corpora whose width or alignment leaves the
              kernel's vector loads (d = 99 and 100, a corpus pointer off
              16 bytes: TMA cannot read them, the kernel's element-wise
              copy does). Prints the kernel's time and achieved TFLOP/s,
              the plain version's time, `library_ms` (torch.topk over
              2 q.x^T - |x|^2, a yardstick the port never calls) and the
              bound, each in ms. The bound's operations term takes the
              faster route for the type: bf16 on the tensor cores (989
              TFLOP/s); f32 the smaller of 2QNd at 67 TFLOP/s (FMA) and
              3 x 2QNd at 495 TFLOP/s (3xTF32 on the tensor cores), which
              is 3xTF32; the route is printed beside it.
  engine      The port's main path at real size: DBConfig(vector_dim=512),
              4 shards, f32, search_mode="approx". Ingests 1,000,000 seeded
              unit vectors with put_rows (device corpus 1,048,576 x 512 f32),
              searches batches of 1, 32 and 256 at k=10 through search_batch
              (110 closed-loop searches each: p50, p90, QPS as all the
              queries over all the time, and the engine's own stage
              timers; then 10 b256 searches under torch.profiler for the
              device's busy share) and through search(SearchRequest), and
              requires recall@10 >= 0.95 against an exact scan of the same
              device corpus. Then
              overwrites, deletes and gets a few keys and checks that
              searches see the changes before and after flush(). The scan
              kernel's launch count is zeroed before this phase and read
              after it; it must be > 0.
  durability  A data_dir engine with the WAL on, 50,000 rows, on the
              native doc store and WAL writer: checkpoint, more puts and
              deletes, then reopen twice (after a crash that leaves a WAL
              tail to replay, and after close()); search results and
              count() must be identical each time, the acknowledged writes
              read back and the deleted keys stay gone. Run twice: RAM
              mirrors, then mmap mirrors, where the checkpoint must
              hardlink the mirror files (same inode) and each reopen adopt
              them.
  serve       The reference's server at real size, driven over real HTTP:
              the engine phase's 1,000,000 seeded unit rows x 512 written
              through the engine (one put_rows, WAL on) into a data_dir
              with DBConfig(vector_dim=512, search_coalesce=True), the rest
              at its defaults (4 shards, f32, "approx", RAM mirrors);
              checkpoint, close, and a DBService reopened on it behind an
              in-process DBServer (build, checkpoint and reopen seconds).
              Load comes from client processes that import http.client,
              json and numpy only (msgpack for the binary wire), so the
              GIL and the card stay the server's. One client, 200
              closed-loop /rpc/search k=10 on JSON: p50 / p90 beside the
              server's service.search, service.batcher_wait and
              search.device p50s and the engine phase's b1 p50; every
              answer's keys equal a direct engine.search_batch of the same
              queries outside near-ties, recall@10 >= 0.95 against an
              exact scan. 16 client processes of closed-loop /rpc/search:
              QPS over the window, p50 / p90, requests per scan launch.
              8 client processes of /rpc/search_batch b32 on the binary
              wire (JSON where msgpack does not import): QPS, p50 and the
              coalescer's search_groups. One client of /rpc/search_batch
              b256 on each wire: p50 beside the engine phase's b256 p50.
              16 clients of 100 /rpc/put each (the BatchingWriter's group
              commit, WAL on) while 16 search clients run: every
              acknowledged key reads back equal through /rpc/get and is
              the top-1 of /rpc/search on its own vector; then 100
              /rpc/delete, gone from get and search. /rpc/profile from a
              handler thread while another client searches: the
              torch.profiler trace must name the scan kernel. The
              batcher's fallbacks must be 0 and the service's engine on
              the native runtime. Close and reopen: the acknowledged puts
              are back, the deleted keys stay gone, count() equal. Where
              click imports, `python3 -m tpuvdb_torch.api.cli serve
              --data-dir D --port P` (64-d) as a subprocess answers
              /healthz, a put and a search and exits 0 on SIGTERM with a
              final checkpoint. The scan kernel's launch count, zeroed
              before this phase, must be > 0 after it. Whether msgpack
              and click import is printed.
  federation  A FederatedCoordinator behind a DBServer over two node
              services on the card, each with a data_dir and the config's
              default replica_count 2; depth cut to 2,000 rows (from the
              serve phase's 1M). 2,000 puts through the coordinator over
              HTTP; each key is held by both nodes (direct /rpc/get on
              each, vectors equal); coordinator searches hold recall@10
              >= 0.95 against an exact scan. One node's server shut down:
              the coordinator's gets (from the replica) and searches still
              answer; 200 more puts. That node reopened from its data_dir
              and synced through the coordinator's `sync` RPC: its gets
              match all 2,200 keys.
  clip        Text -> image search at full ViT-B/32 width (embed_dim 512,
              seed 0; tpuvdb_torch/embed/clip.py, torch ops in f32, no
              hand-written kernel). The towers' init time and device
              bytes; the text tower's p50 at b1 / b8 / b64 and the image
              tower's at b1 / b32 (CUDA events, 30 calls each, with the
              TFLOP/s of their FLOP count); the card's unit embeddings of
              2 texts and 2 pixel batches within 1e-4 of the same towers'
              CPU forward (the seeded weights equal bit for bit). Then
              the serve phase's 1,000,000 unit rows x 512 and 256 rows
              embedded by the image tower (seeded pixels) in a
              DBService(DBConfig(vector_dim=512)) behind a DBServer,
              which loads its own embedder at the first /api/search
              (timed apart). One client process of 100 closed-loop
              /api/search k=10 over 8 captions: p50 / p90 and the
              server's stage p50s; each caption's answer the same every
              time and ascending; its keys and scores equal, apart from
              near-ties, to the engine's own search of the vector this
              script's text2vec gives, to the bucketed exact oracle of the
              same device corpus (the scan's function: the best row of
              each of the 512 buckets, then the top-10) and to the exact
              oracle of it (with these seeds no two of a caption's top-10
              share a bucket), each score its key's exact distance, and
              recall@10 >= 0.95 against the exact oracle. Each image row is
              the top-1 of its own vector at a score < 1e-3. The stages
              of one text search (tokenize, text2vec, the engine's
              search_hits, the service's text_search) in p50s. PNG files
              (Pillow): 4 through put_image, 4 through `python3 -m
              tpuvdb_torch.api.cli --coord-addr A ingest-images` (another
              process embeds them on the card), `cli text-search` shows
              the service's answer, and each file's own vector finds it
              first. The scan kernel's launches, zeroed just before the
              one-client /api/search window and read just after it, must
              be one a request (`launches_by_path` "clip"). Last
              bench/clip_e2e.py at its full shape (a width-768, 12-layer
              text tower, 64 texts, 1,000,000 x 768 int8 rows of seed 0,
              top-10): its JSON line and its stage split (tokenize,
              tower, normalize, int8 scan + top-k); the top-k finite,
              ascending, in range and equal to the stages run one by one.
  bench       `cli bench --suite scan` in this process (cli.main with
              standalone_mode=False, stdout captured; bench/scan.py): the
              reference's seeded adversarial corpus, 1,000,000 x 128
              (padded to 1,048,576), k = 10, its six paths (approx_bf16,
              pallas_bf16 and pallas_bf16_b512 on the scan kernel; int8,
              int8_b128 and int8_rescored as torch ops), then the flat bf16
              engine at b512 and the IVF engine (nlist 1,024, nprobe 64) at
              b8. Every stage line and the last line are parsed: the last
              line has exactly the reference's keys, capacity_pq null;
              recall@10 at least the reference's round-5 levels less 0.01
              (pallas_bf16 0.9712, approx_bf16 0.9666, int8_rescored
              0.9603), engine_recall_at_10 >= 0.95, the IVF keys present.
              The scan's and the f32 probe's launches, zeroed just before
              the suite and read just after, must be > 0
              (`launches_by_path` "bench"). Then the scan kernel against
              its plain twin on the same padded bf16 corpus at Q = 256 and
              512, and the f32 probe against its twin on an IVFIndex over
              the same rows (nlist 1,024, nprobe 64) at Q = 8, with the
              checks of the kernel and ivf kernel phases, and their times.
              Last `python -m tpuvdb_torch.api.cli --device cuda bench
              --suite streaming` as a process (50,000 x 512, WAL on): exit
              0, the reference's keys, a positive rate.
  ivf kernelBuilds an IVFIndex (nlist 1,024, nprobe 64) over a clustered
              1,048,576 x 512 corpus with ~1% dead rows and holds both IVF
              probe kernels against their plain twins, f32 and bf16, at
              Q = 1, 8 and 256: the expanded form as the search picks it,
              the compact form through force_compact, and the compact form
              at Q = 1,024 with a probe set above 2**20 entries (f32 and
              bf16). Candidate
              ids must agree in >= 99.9% of slots; scores and top-10
              distances within 1e-5 of 2|q||x|max + |x|max^2 (f32 sums of
              d products taken in another order). Prints each kernel's
              time and achieved TFLOP/s, its plain twin's time and its
              bound, with the operations' route as in the kernel phase
              (there is no single PyTorch call that computes the probe:
              library_ms is null).
  ivf engine  The reference's IVF serving configuration
              (tpuvdb/bench/engine_serving.py:158-165): DBConfig(vector_dim=
              512, index_type="ivf", ivf_nlist=1024, ivf_nprobe=64,
              ivf_kmeans_iters=6, ivf_train_sample=131072, wal_enabled=
              False), 4 shards, f32, over 1,000,000 rows of the port's
              bench/datasets.py synthetic_corpus (clustered, 1,024 clusters,
              spread 0.4). Build time (put_rows + flush); b1, b8, b32 and
              b256 at k=10 (110 closed-loop searches each: p50, p90, QPS
              over the window); b256 under torch.profiler; recall@10 >= 0.95
              against an exact scan of the same rows. The probe launches
              are zeroed before this phase and read after it; the expanded
              kernel's must be > 0. Then one IVFIndex.search at b1,024 with
              nprobe chosen so Q * nprobe * w128 > 2**20, which takes the
              compact form (its launches, zeroed before, must be > 0), with
              its recall; overwrite, delete and get before and after flush;
              a delta overflow that drains by append; and a 50,000-row
              data_dir restart that reuses the warm centroids (k-means is
              made to fail) and returns identical keys.
  int8 kernel Inside the ivf kernel phase, on the same corpus and dead rows:
              IVFIndex.build(nlist 1,024, nprobe 64, dtype=torch.int8), and
              both int8 probe forms against their plain twins at Q = 1, 8
              and 256, the compact form through force_compact and at
              Q = 1,024 above 2**20 entries. The kernel is the f32/bf16
              probe's template on wgmma s8 (the group table, each chunk
              read once for up to 128 queries); exact int32 dots and f32
              operations rounded once each in both, so candidate ids and
              scores must be equal bit for bit (max_abs_err 0). The bound
              counts 1 byte per element plus 12 per row (scale, norm, mask)
              over the HBM rate and the int8 operations over the
              tensor-core int8 peak.
  flat int8   DBConfig(vector_dim=512, storage_dtype="int8"), the rest at
              its defaults (4 shards, flat, rescore_mode="exact",
              rescore_overfetch=16), over the engine phase's 1,000,000 unit
              rows: build time, b1 / b32 / b256 at k=10 with the stage
              timers and the host rescore's share, b256 under
              torch.profiler (the torch ops of the int8 scan), recall@10 >=
              0.95 against an exact f32 scan, the device index's bytes
              beside an f32 one's, the rescore phase (below); then a
              rescore_mode="device" engine and
              a "none" engine at b256 (latency and recall, reported). This
              path is torch ops (`_int_mm`, top-k): it launches no
              hand-written kernel, and the line it prints says so.
  ivf int8    The IVF serving configuration with storage_dtype="int8" over
              the ivf engine phase's rows: build time, b1 / b8 / b32 / b256
              at k=10, recall@10 >= 0.95 with the exact rescore and the
              recall of a rescore_mode="none" engine (reported), a b1,024
              index search through the compact int8 kernel, the write
              checks with a delta-overflow append, and a 50,000-row warm
              restart (with int8 mirrors); the rescore phase; and an engine
              with int8 mirrors (mirror_dtype="int8"): b256, its recall
              (reported: the re-rank ranks the stored int8 rows, so their
              quantization bounds it), and the rescore phase on them. The int8 probe launches are
              zeroed before the engine's searches and before the index
              search, and must be > 0 after each.

  pq kernel   The IVF-PQ probe kernel against its plain twin at the capacity
              shape of the reference's own run (scripts/bench_capacity_pq.py:
              68-75): d = 768, 96 code bytes a row, 256 codes a subspace,
              nlist 4,096 cells of 2,048 rows (a code table of 8,388,608 rows,
              805 MB; seeded random codes, codebooks and centroids, ~1% dead
              rows, so no build is needed), nprobe 64, fetch k = 640 (10
              segments), at Q = 1, 8, 32 and 256; the 4-bit tier (96 bytes,
              192 subspaces of 16 codes) at Q = 32; and a ragged case (50
              bytes a row from a base off 16 bytes, the kernel's byte loads)
              at Q = 8. Candidate ids and scores must be equal bit for bit
              (the same bf16 entries added in the same order, each f32
              addition rounded once in both). The bound is the larger of
              bytes (distinct chunks x 128 x (Mb + 4), the LUTs, the coarse
              product, the lists, the outputs) over the HBM rate and the
              lookups (per tile QT x rows x M2) over the card's rate for
              them. With 256 codes a subspace that is the shared-memory
              rate for a bf16 entry: SMs x 128 bytes a clock / 2 bytes x the
              card's maximum SM clock (nvidia-smi clocks.max.sm). The kernel
              stages the LUT interleaved by query ([m][code][G]) and serves
              G queries of a tile (G = 4 at 64 and 96 code bytes) from one
              wide load a code, which a bank word carries whole.
              With 16 codes a subspace's table is 32 bytes and fits in
              registers, so shared memory is no floor: there the operations
              are the f32 additions, one a lookup, at SMs x 128 lanes a
              clock.
  ivf pq      The IVF serving configuration with ivf_pq_subq=64 (8-bit codes,
              64 bytes a row; ivf_pq_rescore_overfetch=64, adaptive rescore
              and packed checkpoint at their defaults) over the ivf engine
              phase's rows: build time, device index bytes beside the f32 and
              int8 figures, b1 / b8 / b32 / b256 at k=10 (40 closed-loop
              searches each) with the stage timers, rescored and skipped
              rows, b256 under torch.profiler, the rescore phase,
              recall@10 >= 0.95 against the
              exact f32 scan under the exact rescore (were the default window
              to miss it, the first wider window that reaches it is reported
              and named; the limit stays), the PQ kernel against its twin on
              the engine's own index at b256, the write checks with a
              delta-overflow append, an append that fills a cell and spills,
              and a 50,000-row restart that takes the packed file
              (ivf_packed_restores == 1, no build, identical results). Then
              one b256 run (10 searches) each of a 4-bit engine
              (ivf_pq_bits=4) and an OPQ engine (ivf_opq=True), recall
              reported and held to the limit.
              The PQ launches are zeroed before the engine's searches and
              must be > 0 after them.

  mesh        Every mesh path on MESH_SLOTS = 4 slots of the one card
              (`create_mesh(devices=["cuda:0"] * 4)`: each slot holds its
              own tensors and runs its own launches, as over four cards).
              Flat, over the engine phase's 1,000,000 rows x 512 (262,144
              a slot): a single-device "exact" engine's keys at b1, b32
              and b256 against a 4-slot "exact" engine's and, on a 2x2
              `create_mesh_2d` (4.3 GB: two copies), at b256 and b255 (the
              pad), ids equal outside near-ties (the serve phase's
              tolerance); then DBConfig(vector_dim=512) ("approx") on 4
              slots: b1 / b32 / b256 latency and QPS, b256 under
              torch.profiler, recall@10 >= 0.95 against the exact engine,
              and the scan's launches (zeroed before, > 0 after:
              `launches_by_path` "mesh"). IVF: the ivf engine phase's
              configuration (nlist 1,024 // 4 = 256 a shard, nprobe 64)
              over its first MESH_IVF_ROWS rows on 4 slots, f32, int8 and
              64-byte PQ: build time, b1 / b256, recall@10 >= 0.95 (PQ
              under the exact rescore), the probe launches of each (> 0),
              the write checks with a delta-overflow append (the PQ one
              through the per-row centroid encode), and a 50,000-row f32
              restart in which k-means is made to fail (held to recall:
              the warm table's cells are bisected again, as in the
              reference). NCCL: `initialize_multihost` at world size 1
              and a `sharded_search` over the process mesh equal to the
              in-process one, then `shutdown_multihost`. Across processes:
              two worker processes (`_MESH_WORKER_SRC`, spawned) on
              `cuda:0`, two slots each, join a gloo group themselves and
              call `initialize_multihost` (NCCL takes one rank a card);
              each records whether gloo's all_gather takes CUDA tensors,
              then runs a 2x2 "exact" flat engine over the same 1,000,000
              rows (b256 and b255), the default ("approx") flat engine on
              4 slots (b256: the scan) and 4-slot IVF f32 and 64-byte PQ
              engines over the MESH_IVF_ROWS rows (PQ at the window the
              in-process engine served), every call in both workers. Both
              workers' keys must equal each other and the in-process
              mesh's outside near-ties, recall@10 >= 0.95, and the scan,
              f32-probe and PQ-probe launches > 0 in each worker; each
              worker's seconds and the sub-phase's are printed. Last the
              dry run `dryrun_multichip(4, devices=["cuda:0"] * 4)`, each
              path against its numpy oracle. The phase's seconds are
              printed.
  rescore     On the flat int8, IVF int8 (f32 and int8 mirrors) and IVF-PQ
              engines: the candidate rows of one real b256 search go through
              the native and the numpy forms of the exact re-rank on the
              same mirrors (`_rescore_exact`; on the adaptive IVF-PQ path
              also `_exact_masked` over the window and `_rescore_adaptive`).
              Distances within 1e-5 of |q|^2 + max |x|^2 plus 1e-4 (the CPU
              tests' tolerance, scaled by the terms that cancel), top-10
              ids equal except inside near-ties of that width, the
              adaptive counters equal; each form's time (fastest of 3) and
              the rows and bytes read are printed.

  capacity    After the mesh phase: capacity_engine and capacity_pq set
              keep_malloc_warm (a process-wide mallopt, as the reference's
              scripts do), so only the ops phase runs after it (its
              cluster in processes of its own; its wire bench and serving
              A/B in this process, under the mallopt). The latency and capacity benches in this process
              through their main(argv, device="cuda"), stdout captured,
              each one's engine and arrays freed before the next (the
              anonymous RSS is printed after each). bench/latency.py at the
              reference's 100,000 x 512 and 200 reps, three times: --mode
              approx (the scan's launches > 0), --mode int8, and --index
              ivf --mode approx (the f32 probe's launches > 0); three lines
              each with the reference's keys and a positive p50
              (`launches_by_path` "latency"). Then each capacity bench at
              its CAPACITY_ROWS rows (250,000, cut from 8,000,000 to fit
              the run's time limit; every other width is the
              reference's): bench/capacity.py (the rescored paths' recall
              >= 0.95, the plain int8 recalls printed), capacity_engine.py
              (recall@10 >= 0.95; its restart counts every row or raises;
              device GiB, ingest, build, QPS, checkpoint and restart
              printed), capacity_ivf.py (its nprobe the reference's choice
              from the sweep it prints: the first at recall 0.95, else the
              last, 256; whether 0.95 was reached is printed, and on this
              data it is not at 1M or 8M rows: PERF.md; b1 / b8 / b128
              present, the int8 probe's launches > 0; then on the index
              its main returns the int8 probe against its plain twin bit
              for bit at Q = 8 and 128, with times and bounds) and
              capacity_pq.py (--out in a temp dir: its file equals the last
              line, stage "complete"; served recall >= 0.95, printed beside
              the data's recall in the reference's record; the PQ probe's
              launches > 0; kernel_probe b32 and b256; both serving batches
              above 0; the restart counts every row or raises; the build
              split printed; then on the index its main returns, the
              restarted engine's, the PQ probe against its plain twin bit
              for bit at Q = 8 and 256, with times and bounds;
              `launches_by_path` "capacity" of both probes). Last the
              examples: `python -m tpuvdb_torch.examples.quickstart` as a
              process in a temp working directory (exit 0, img_01234.jpg
              first) and sharded_serving.main on four slots of the card
              (self-retrieval 64/64). capacity_ivf's corpus and oracle
              cache ($TPUVDB_BENCH_CACHE) and its index, and capacity_pq's
              data dir, are kept for the ops phase. `capacity_alone(rows)`
              runs the capacity benches alone at any rows (8,000,000 is
              theirs); with diag=True each is followed by its diagnostic
              (below) on what it kept.
  ops         Last, the port's ops scripts and the last reference scripts.
              tpuvdb_torch/scripts/start_cluster.sh demo with
              TPUVDB_DEVICE=cuda on free ports and a temp cluster dir: a
              coordinator and 3 `serve` processes on the card (512-d
              default config), 8 seeded keys put through the coordinator,
              `search -k 1`, node0 killed, 7 s, all 8 gets, a search
              again, stop; every CLI call a new process. It must exit 0,
              print FAILOVER OK and give key3 as top-1 before and after
              the kill. A thread polls the processes while it runs: each
              node's info RPC must show device cuda:0, device_rows > 0
              and a search.device count that rose over the demo;
              nvidia-smi --query-compute-apps must list the node
              processes. Printed: each process's start-up seconds (its
              pidfile to its first answer) and card memory, the seconds
              from node0's kill to the coordinator marking it offline,
              the seconds of a put / search / get CLI process beside the
              nodes' search.device p50. After `stop` no process of the cluster may be left.
              bench/wire.py at OPS_WIRE_ROWS x 512 (10,000 of its default
              100,000, cut to fit the run's time limit):
              each wire's timed export counts every row, sync_all
              succeeds, its JSON line. bench/serving_ab.py at OPS_AB_ROWS
              x 128 (250,000 of its default 1,000,000, cut to fit the
              run's time limit), b32 and b512, 8 threads: for
              each batch the coalesced engine's first answer equals the
              direct engine's (distances within rtol 1e-5, keys equal
              outside exact ties), the scan's launches > 0. Then
              diag_pq_recall on capacity_pq's kept data dir (nprobe 16, 64
              and the one it served x overfetch 10, 40, 100): the recall at
              the setting capacity_pq served equals what it printed, the PQ
              probe's launches > 0; and diag_ivf_b1 on capacity_ivf's kept
              cache and index (the b1 split, recall@10; its approx and cps
              variants "n/a"), the int8 probe's launches > 0. The phase's
              seconds are printed.
At the end a table gives each engine's b1 and b256 stage p50s
(search.device, search.assemble, search.rescore), p50 and idle share.
The last two lines of standard output are the card's name and power limit
(as nvidia-smi reports them) and the JSON result line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth,
# f32 outside the tensor cores, dense tf32, bf16 and int8 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              torch.int8: 1979e12}
PEAK_TF32 = 495e12
# an f32 product computed f32-accurately on the tensor cores (3xTF32: three
# tf32 products) costs 3 tf32 operations
TF32_PER_F32 = 3

SCAN_N = 1 << 20
SCAN_D = 512
SCAN_QS = (1, 64, 256)
BUCKETS = 512
SLOT_AGREE_MIN = 0.999
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-3
TOPK_RTOL = 1e-5
# (d, corpus dtype, corpus pointer offset in elements)
RAGGED_WIDTHS = ((100, torch.float32, 0), (99, torch.float32, 0),
                 (128, torch.float32, 1), (100, torch.bfloat16, 0),
                 (96, torch.bfloat16, 1))
RAGGED_N, RAGGED_Q = 70_001, 37

ENGINE_ROWS = 1_000_000
ENGINE_BATCHES = (1, 32, 256)
SEARCH_REPS = 110  # p90 then has 11 samples beyond it
RECALL_MIN = 0.95
DURABLE_ROWS = 50_000

SERVE_ROWS = 1_000_000
SERVE_ONE_CLIENT = 200   # closed-loop /rpc/search of the single client
SERVE_CLIENTS = 16       # search client processes
SERVE_CLIENT_REQS = 60   # closed-loop /rpc/search of each
SERVE_BATCH_CLIENTS = 8
SERVE_BATCH = 32
SERVE_BATCH_REQS = 40
SERVE_B256_REQS = 15     # of each wire
SERVE_PUT_CLIENTS = 16
SERVE_PUTS = 100         # /rpc/put of each put client
SERVE_MIXED_REQS = 30    # /rpc/search of each search client beside them
SERVE_DELETES = 100
FED_ROWS = 2_000         # federation depth, cut from the serve phase's 1M
FED_DOWN_PUTS = 200      # puts while a node is down
FED_QUERIES = 100

IVF_N = 1 << 20
IVF_D = 512
IVF_NLIST = 1024
IVF_NPROBE = 64
IVF_QS = (1, 8, 256)
IVF_COMPACT_Q = 1024     # with a probe set above 2**20 entries
IVF_SCORE_TOL = 1e-5     # of 2|q||x|max + |x|max^2 per query
IVF_ENGINE_ROWS = 1_000_000
IVF_BATCHES = (1, 8, 32, 256)
IVF_RESTART_ROWS = 50_000
SIDE_REPS = 30           # b256 searches of the "device" / "none" engines
RESCORE_REPS = 3         # timed calls of each rescore form
RESCORE_RTOL = 1e-5      # of |q|^2 + max |x|^2 (the terms that cancel),
RESCORE_ATOL = 1e-4      # plus this: the CPU tests' tolerance, scaled

# the reference's capacity run (scripts/bench_capacity_pq.py:68-75)
PQ_D = 768
PQ_BYTES = 96
PQ_NLIST = 4096
PQ_CELL = 2048
PQ_NPROBE = 64
PQ_FETCH = 640           # k = 10 at ivf_pq_rescore_overfetch = 64
PQ_QS = (1, 8, 32, 256)
PQ_ENGINE_BYTES = 64     # ivf_pq_subq of the engine phase (d = 512)
PQ_REPS = 40             # closed-loop searches per batch size
PQ_SIDE_REPS = 10        # b256 searches of the 4-bit and OPQ engines
PQ_WINDOWS = (64, 128, 256, 512)  # rescore windows tried, in order
CLIP_BATCHES_TEXT = (1, 8, 64)   # text tower batches timed
CLIP_BATCHES_IMAGE = (1, 32)     # image tower batches timed
CLIP_REPS = 30           # CUDA-event timings of each tower batch (p50)
CLIP_IMAGES = 256        # corpus rows embedded by the image tower
CLIP_PNGS = 8            # PNG files through put_image and ingest-images
CLIP_ONE_CLIENT = 100    # closed-loop /api/search of the single client
CLIP_STAGE_REPS = 50     # in-process text-search stage timings (p50)
CLIP_ATOL = 1e-4         # card vs CPU forward, on unit embeddings
CLIP_TEXTS = ("a photo of a cat", "a dog running in the park",
              "a red bus on a city street", "two people on a beach",
              "a bowl of fruit on a wooden table", "snow on the mountains",
              "an old car parked by a house",
              "a plate of food next to a glass of wine")
E2E_N, E2E_DIM, E2E_BATCH, E2E_K = 1_000_000, 768, 64, 10  # clip_e2e
# bench phase: the recall@10 of the reference's round-5 run on the same
# adversarial corpus (ROADMAP.md item 13), each floor 0.01 below it
BENCH_ROUND5_RECALL = {"pallas_bf16": 0.9812, "approx_bf16": 0.9766,
                       "int8_rescored": 0.9703}
BENCH_RECALL_SLACK = 0.01
BENCH_HOLD_QS = (256, 512)  # scan kernel vs plain at the bench's shape
BENCH_PROBE_Q = 8           # the bench's IVF small batch
BENCH_PATHS = ("approx_bf16", "int8", "int8_b128", "int8_rescored",
               "pallas_bf16", "pallas_bf16_b512")
BENCH_SCAN_KEYS = {"metric", "value", "unit", "vs_baseline", "recall_at_10",
                   "best_path", "batch", "corpus", "dataset", "paths",
                   "engine", "capacity_pq"}
BENCH_IVF_KEYS = {"ivf_build_s", "ivf_p50_ms_per_query",
                  "ivf_p95_ms_per_query", "ivf_batch"}
BENCH_STREAMING_KEYS = {"metric", "value", "unit", "vs_baseline",
                        "ingest_total", "dim", "concurrent_search_p50_ms",
                        "recovery_s"}
# the capacity phase: each bench's rows, in the order they run, cut from
# 8,000,000 so the whole run stays inside its 1,200 s limit beside the
# mesh phase's processes (at 8M the four take about 33 min on the card's
# machine, mostly host work; at 1,000,000 rows, 500,000 for capacity_ivf,
# the run took 1,168 s; 250,000 since the ops phase came after them:
# PERF.md section 4). capacity_ivf's build's host bisection grows faster
# than its rows (24 s at 500,000 rows, ~1,000 s at 8M). dim, code bytes,
# nlist, nprobe, k and the batches are the benches' own;
# capacity_alone(rows) runs them at any size
CAPACITY_ROWS = {"capacity": 250_000, "capacity_engine": 250_000,
                 "capacity_ivf": 250_000, "capacity_pq": 250_000}
LATENCY_RUNS = (("approx", "flat"), ("int8", "flat"), ("approx", "ivf"))
LATENCY_KEYS = {"metric", "unit", "value", "per_query_p50_ms", "p99_ms",
                "mode", "index", "dispatch_floor_ms", "p50_minus_dispatch_ms",
                "per_query_p50_minus_dispatch_ms", "rows"}
CAPACITY_KEYS = {"int8_b128", "int8_b256", "int8_resc_b128",
                 "int8_resc_b256"}
CAPACITY_ENGINE_KEYS = {"metric", "rows", "dim", "ingest_rows_per_s",
                        "build_s", "device_gib", "recall_at_10",
                        "engine_qps_single", "engine_qps_pipelined",
                        "checkpoint_s", "restart_s", "peak_rss_gb",
                        "anon_rss_gb"}
CAPACITY_IVF_KEYS = {"nprobe", "recall_at_10", "nlist", "cell_pad", "rows",
                     "dim", "hbm_gib", "b1", "b8", "b128"}
CAPACITY_PQ_KEYS = {"metric", "rows", "dim", "pq_subq", "pq_bits", "nprobe",
                    "ingest_rows_per_s", "build_s", "codes_gib_hbm",
                    "recall_at_10", "recall_sweep", "kernel_probe",
                    "engine_qps_single", "engine_qps_pipelined",
                    "serving_by_batch", "checkpoint_s", "restart_s",
                    "restart_split", "peak_rss_gb", "anon_rss_gb",
                    "adaptive_rescore", "pq_err", "opq", "stage",
                    "rss_stages"}
# the served recall of this data at 8M rows and nprobe 16 in the
# reference's own record (docs/BENCH_PQ8M_r4.json, an earlier revision of
# its code): a property of the data and the re-rank window, no time. Its
# later record of 16M rows (docs/BENCH_PQ16M_r5.json) has 0.9187 at the
# default window of 640 candidates and 0.9719 at 1,280 (--overfetch 128)
CAPACITY_PQ_DATA_RECALL = 0.9781
CAPACITY_HOLD_QS = {"capacity_ivf": (8, 128), "capacity_pq": (8, 256)}
# the ops phase (after the capacity phase): the port's ops scripts and the
# last reference scripts
OPS_NODES = 3            # start_cluster.sh demo's data nodes
OPS_DEMO_TIMEOUT = 600   # seconds the demo may take
OPS_POLL_S = 0.02        # the cluster poller's interval
# bench/wire.py at 10,000 rows of its default 100,000: at 100,000 its
# JSON export alone took 65.3 s (PERF.md section 4)
OPS_WIRE_ROWS = 10_000
# bench/serving_ab.py at 250,000 rows of its default 1,000,000 (17.3 s
# there, PERF.md section 4)
OPS_AB_ROWS = 250_000
OPS_PQ_NPROBES = (16, 64)   # diag_pq_recall's defaults, plus the served one
WIRE_KEYS = {"metric", "rows", "dim", "payload_mb", "export_json_s",
             "export_json_mb_s", "export_binary_s", "export_binary_mb_s",
             "export_speedup", "sync_all_2node_s", "sync_all_peak_records"}
MESH_SLOTS = 4           # slots of the one card (a device may repeat)
MESH_ODD_BATCH = 255     # pads to the replica groups
MESH_REPS = 20           # closed-loop searches of each IVF mesh batch
# IVF / IVF-PQ depth on the mesh, in process and across processes: cut
# from 1,000,000 so the run ends inside its 1,200 s on a slow host (at 1M
# it took 1,139.9 s, the mesh phase 366.4 s of it: PERF.md section 4).
# At 250,000 the delta-overflow write check's rows drain by a rebuild,
# not the append it checks for
MESH_IVF_ROWS = 500_000
NCCL_ROWS = 1 << 18      # the corpus of the NCCL process-mesh check
SMEM_BYTES_PER_CLOCK = 128  # an SM's shared memory: 32 banks x 4 bytes
LUT_ENTRY_BYTES = 2         # the table holds bf16
F32_LANES_PER_CLOCK = 128   # an SM's f32 additions a clock


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2, median: bool = False) -> float:
    """Device time of one fn() call by CUDA events, in ms: the mean over
    reps back-to-back calls, or with `median` the median of reps windows
    of one call each."""
    for _ in range(warmup):
        fn()
    if median:
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scan_work(nq: int, n: int, d: int, dtype) -> dict:
    """Each input read once, each output written once; 2*Q*N*d
    operations."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (n * d * item + 2 * n * 4 + nq * d * 4
              + nq * BUCKETS * (4 + 4))
    return {"bytes": nbytes, "ops": 2.0 * nq * n * d}


def ops_ms(ops: float, dtype) -> tuple:
    """(ms, route): the least time of `ops` operations of the data type on
    the card. f32 takes the faster of its two routes: f32 FMA outside the
    tensor cores, or 3xTF32 on them (three tf32 operations each)."""
    if dtype == torch.float32:
        fma = ops / PEAK_FLOPS[dtype] * 1e3
        tc = TF32_PER_F32 * ops / PEAK_TF32 * 1e3
        return (tc, "3xTF32 tensor cores") if tc < fma else (fma, "f32 FMA")
    return ops / PEAK_FLOPS[dtype] * 1e3, f"{str(dtype).split('.')[-1]} tensor cores"


def _bound(work: dict, dtype) -> tuple:
    """(ms, 'bytes'|'operations', route of the operations): the larger of
    the bytes over the HBM rate and the operations over the peak of their
    route."""
    t_bytes = work["bytes"] / PEAK_BYTES_PER_S * 1e3
    t_ops, route = ops_ms(work["ops"], dtype)
    if t_bytes >= t_ops:
        return t_bytes, "bytes", route
    return t_ops, "operations", route


def tflops(ops: float, ms: float) -> float:
    """Achieved rate of the algorithm's operations (2 per multiply-add;
    3xTF32's three products count once), TFLOP/s."""
    return ops / (ms * 1e-3) / 1e12


def check_native(eng, label: str) -> None:
    """The engine runs on the native host runtime: the C++ doc store with
    fastlist, the fused rescore and, with a data_dir, the native WAL
    writer."""
    info = eng.info()
    want = {"docstore_backend": "native", "rescore_backend": "native",
            "fastlist": True}
    if eng.wal is not None:
        want["wal_backend"] = "native"
    got = {k: info[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: not on the native runtime: {got}")


def build_native() -> dict:
    """Builds the native host runtime (tpuvdb_torch/native) from the
    checkout with g++, and, apart from it, compiles its source once more
    into a temp dir with -fopt-info-vec-all for the vectorizer's report on
    the two rescore dot loops (logged, not asserted)."""
    from tpuvdb_torch import native

    t0 = time.perf_counter()
    native.load()
    out = {"load_s": time.perf_counter() - t0,
           "build_s": dict(native.build_seconds)}
    src = os.path.join(native.SRC_DIR, "tpuvdb_native.cpp")
    with open(src) as f:
        loops = [i + 1 for i, line in enumerate(f) if "acc +=" in line]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             "-fopt-info-vec-all", src, "-o", os.path.join(tmp, "v.so")],
            capture_output=True, text=True)
    report = sorted({line.split(src + ":", 1)[1]
                     for line in proc.stderr.splitlines()
                     if any(f"{src}:{n}:" in line for n in loops)
                     and ("vectorized" in line or "couldn't" in line)})
    out.update(dot_loop_lines=loops, vectorizer=report)
    return out


# --------------------------------------------------------------- phase 1


def phase_kernel(scan) -> dict:
    """Kernel vs plain at full size; returns the figures for the JSON."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    corpus32 = torch.randn((SCAN_N, SCAN_D), generator=gen, device=dev)
    sq = {}
    corpora = {torch.float32: corpus32,
               torch.bfloat16: corpus32.to(torch.bfloat16)}
    for dt, c in corpora.items():
        sq[dt] = c.float().pow(2).sum(dim=1)
    valid = torch.rand(SCAN_N, generator=gen, device=dev) >= 0.01
    neg_mask = torch.zeros(SCAN_N, device=dev).masked_fill_(~valid,
                                                            scan.NEG_INF)
    queries = torch.randn((max(SCAN_QS), SCAN_D), generator=gen, device=dev)
    rows = []
    max_err = 0.0
    for dt, corpus in corpora.items():
        cases = [(nq, SCAN_N) for nq in SCAN_QS] + [(64, SCAN_N - 123)]
        for nq, n in cases:
            q = queries[:nq]
            x, s, m, v = corpus[:n], sq[dt][:n], neg_mask[:n], valid[:n]
            name = f"{str(dt).split('.')[-1]} Q={nq} N={n} d={SCAN_D}"
            max_err = max(max_err, _hold(scan, name, q, x, s, m, v))
            if n != SCAN_N:
                continue
            reps = 20 if nq <= 64 else 5
            ms = cuda_ms(lambda: scan.scan_candidates(q, x, s, m, BUCKETS),
                         reps)
            plain_ms = cuda_ms(
                lambda: scan.scan_candidates_plain(q, x, s, m, BUCKETS), 3, 1)
            lib_ms = cuda_ms(lambda: _library_topk(q, x, s, 10), 3, 1)
            work = scan_work(nq, n, SCAN_D, dt)
            bound, by, route = _bound(work, dt)
            row = {"dtype": str(dt).split(".")[-1], "Q": nq, "N": n,
                   "d": SCAN_D, "ms": ms, "tflops": tflops(work["ops"], ms),
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bound, "bound_by": by, "bound_route": route}
            rows.append(row)
            log("kernel timing " + json.dumps(row))
    del corpora, corpus32
    torch.cuda.empty_cache()

    # widths and alignments off the kernel's vector loads: d % 16 != 0
    # leaves a partial last depth slice; d % 4 (f32) or d % 8 (bf16) != 0,
    # or a corpus pointer off 16 bytes, takes the scalar loads
    for d, dt, offset in RAGGED_WIDTHS:
        flat = torch.randn(RAGGED_N * d + offset, generator=gen,
                           device=dev).to(dt)
        x = flat[offset:].view(RAGGED_N, d)
        s = x.float().pow(2).sum(dim=1)
        v, m = valid[:RAGGED_N], neg_mask[:RAGGED_N]
        q = torch.randn((RAGGED_Q, d), generator=gen, device=dev)
        name = (f"{str(dt).split('.')[-1]} Q={RAGGED_Q} N={RAGGED_N} d={d} "
                f"pointer mod 16 = {x.data_ptr() % 16}")
        max_err = max(max_err, _hold(scan, name, q, x, s, m, v))

    main = next(r for r in rows if r["dtype"] == "float32" and r["Q"] == 256)
    return {"rows": rows, "main": main, "max_abs_err": max_err}


def _hold(scan, name, q, x, s, m, v) -> float:
    """Holds the kernel against the plain version on one input; raises on
    disagreement, returns the largest candidate score difference."""
    val_k, idx_k = scan.scan_candidates(q, x, s, m, BUCKETS)
    val_p, idx_p = scan.scan_candidates_plain(q, x, s, m, BUCKETS)
    torch.cuda.synchronize()
    agree = (idx_k == idx_p).float().mean().item()
    err = (val_k - val_p).abs()
    tol = SCORE_ATOL + SCORE_RTOL * val_p.abs()
    worst = (err / tol).max().item()
    d_k, _ = scan.scan_l2sq_topk(q, x, s, v, 10)
    d_p, _ = _plain_topk(scan, q, x, s, v, 10)
    top_rel = ((d_k - d_p).abs() / d_p.abs()).max().item()
    log(f"kernel check {name}: slots agree {agree:.6f}, "
        f"max |score diff| {err.max().item():.3e} "
        f"({worst:.3f} of tol), top-10 max rel diff {top_rel:.3e}")
    if agree < SLOT_AGREE_MIN:
        raise AssertionError(f"{name}: only {agree:.6f} of slots agree")
    if worst > 1.0:
        raise AssertionError(f"{name}: candidate scores disagree beyond "
                             f"rtol {SCORE_RTOL} + atol {SCORE_ATOL}")
    if top_rel > TOPK_RTOL:
        raise AssertionError(f"{name}: top-10 distances disagree beyond "
                             f"rtol {TOPK_RTOL}")
    return err.max().item()


def _plain_topk(scan, q, x, s, valid, k):
    """scan_l2sq_topk's epilogue over the plain candidates."""
    neg_mask = torch.zeros(valid.shape, device=valid.device).masked_fill_(
        ~valid, scan.NEG_INF)
    val, idx = scan.scan_candidates_plain(q, x, s, neg_mask, BUCKETS)
    neg, pos = torch.topk(val, k, dim=1)
    rows = torch.gather(idx, 1, pos)
    q_sq = (q.float() ** 2).sum(dim=1, keepdim=True)
    return q_sq - neg, rows


def _library_topk(q, x, s, k):
    """One PyTorch call computing the exact top-k of the same scores."""
    return torch.topk(2.0 * (q.to(x.dtype) @ x.T).float() - s, k, dim=1)


# --------------------------------------------------------------- phase 2


def _unit_rows(rng, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _timed_searches(eng, label: str, queries, batches, out: dict,
                    reps: int = SEARCH_REPS) -> None:
    """Closed-loop search_batch calls at k=10 for each batch size: p50,
    p90, QPS over the window and the engine's stage timers, into out[bN]."""
    from tpuvdb_torch.utils.tracing import StageTimer

    check_native(eng, label)
    for b in batches:
        q = queries[:b]
        eng.search_batch(q, 10)  # warm
        eng.timers = StageTimer()
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            eng.search_batch(q, 10)
            times.append(time.perf_counter() - t)
        p50, p90 = (float(np.percentile(times, p)) * 1e3 for p in (50, 90))
        qps = b * len(times) / sum(times)
        stages = {name: st["p50_ms"]
                  for name, st in eng.timers.snapshot().items()}
        out[f"b{b}"] = {"p50_ms": p50, "p90_ms": p90, "n": len(times),
                        "qps": qps, "stage_p50_ms": stages}
        log(f"{label} search b{b} k=10: p50 {p50:.3f} ms, p90 {p90:.3f} ms "
            f"(n={len(times)}), {qps:.1f} QPS over the window, "
            f"stage p50s {stages}")


def phase_engine(tt, scan) -> dict:
    from tpuvdb_torch.core.types import SearchRequest, VectorData
    from tpuvdb_torch.kernels.distance import l2sq_topk

    rng = np.random.default_rng(0)
    cfg = tt.DBConfig(vector_dim=512)
    assert cfg.search_mode == "approx" and cfg.storage_dtype == "float32"
    eng = tt.VectorDBEngine(cfg)
    data = _unit_rows(rng, ENGINE_ROWS, cfg.vector_dim)
    keys = [f"doc{i}" for i in range(ENGINE_ROWS)]
    queries = _unit_rows(rng, max(ENGINE_BATCHES), cfg.vector_dim)

    t0 = time.perf_counter()
    res = eng.put_rows(keys, data)
    assert res.success, res.message
    eng.flush()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    idx = eng._index
    log(f"engine ingest: {ENGINE_ROWS} rows in {ingest_s:.3f} s "
        f"(device corpus {tuple(idx.vectors.shape)} {idx.vectors.dtype})")

    out = {"ingest_s": ingest_s, "rows": ENGINE_ROWS,
           "device_rows": idx.layout.total_rows}
    _timed_searches(eng, "engine", queries, ENGINE_BATCHES, out)
    out["b256_device"] = _device_share(eng, queries, "engine")

    # recall@10 against an exact scan of the same device corpus
    d_a, k_a = eng.search_batch(queries, 10)
    q_t = torch.from_numpy(queries).cuda()
    _, rows = l2sq_topk(q_t, idx.vectors, idx.sqnorms, idx.valid, 10,
                        mode="exact")
    rows = rows.cpu().numpy()
    hit = 0
    for i in range(len(queries)):
        truth = {eng.docstore.key_at(*idx.layout.shard_slot_of(int(r)))
                 for r in rows[i] if r >= 0}
        hit += len(truth & set(k_a[i]))
    recall = hit / (10 * len(queries))
    out["recall_at_10"] = recall
    log(f"engine recall@10 (approx vs exact, {len(queries)} queries): "
        f"{recall:.4f}")
    if recall < RECALL_MIN:
        raise AssertionError(f"recall@10 {recall} < {RECALL_MIN}")

    # through the request API
    r = eng.search(SearchRequest(query_vector=queries[0].tolist(), top_k=10))
    assert r.success and len(r.search_result.hits()) == 10, r.message
    assert r.search_result.hits()[0].key == k_a[0][0]

    # writes are visible before and after flush()
    probe = _unit_rows(rng, 1, cfg.vector_dim)
    eng.put(VectorData(key="doc5", vector=probe[0].tolist()))
    victim = k_a[1][0]
    assert eng.delete(victim).success
    for when in ("before flush", "after flush"):
        _, kp = eng.search_batch(probe, 10)
        assert kp[0][0] == "doc5", (when, kp[0][:3])
        _, kv = eng.search_batch(queries[1:2], 10)
        assert victim not in kv[0], (when, victim)
        got = eng.get("doc5")
        assert np.allclose(got.vector_data.vector, probe[0]), when
        assert not eng.get(victim).success, when
        eng.flush()
    assert eng.count() == ENGINE_ROWS - 1
    log("engine overwrite/delete/get visible before and after flush: ok")
    eng.close()
    return out


def _device_share(eng, queries, label: str) -> dict:
    """Device busy time over wall time for b256 searches, from a
    torch.profiler trace: the self times of the device-side events
    (kernels and copies) summed. The host-side op that launched a kernel
    reports the same time again and is left out. "not measured" if the
    profiler sees no device activity. Beside it the host side: the self
    time of each host op and call per search (top 10; a wait on the card
    shows under the call that waited)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    reps = 10
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            eng.search_batch(queries, 10)
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name, host = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            # host side: the self time of each op and call (launches,
            # allocations, copies, waits), what the host spends per search
            if ev.self_cpu_time_total > 0:
                host[ev.key] = ev.self_cpu_time_total / 1e3 / reps
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            by_name[ev.key] = us / 1e3 / reps
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    res = {"wall_ms_per_search": wall_ms / reps,
           "host_op_ms_per_search": sum(host.values()),
           "top_host_ms": dict(sorted(host.items(),
                                      key=lambda kv: -kv[1])[:10])}
    if busy <= 0:
        res["device_busy"] = "not measured"
    else:
        res.update(device_busy_ms_per_search=busy,
                   device_idle_share=1.0 - busy * reps / wall_ms,
                   top_device_ms=dict(top))
    log(f"{label} b256 under torch.profiler: {json.dumps(res)}")
    return res


# --------------------------------------------------------------- phase 3


def _linked(eng, ckpt: str) -> bool:
    """Every mirror file of the engine shares its inode with the
    checkpoint's file of the same shard and part (a hardlink)."""
    return all(os.stat(path).st_ino
               == os.stat(os.path.join(ckpt, f"shard_{s}.{part}")).st_ino
               for s, m in enumerate(eng.mirrors)
               for part, path in m.file_paths.items())


def phase_durability(tt, mirror_backend: str = "ram") -> dict:
    """A data_dir engine on the native doc store and WAL writer: write,
    checkpoint, a WAL tail of puts and deletes, a crash (the WAL writer
    closed, no checkpoint), then reopen twice (WAL tail replay, then after
    close()). Each reopen returns the acknowledged writes, loses the
    deleted keys and searches identically. With mmap mirrors the
    checkpoint hardlinks the mirror files and each reopen adopts them."""
    label = f"durability ({mirror_backend} mirrors)"
    rng = np.random.default_rng(7)
    cfg = tt.DBConfig(vector_dim=512, checkpoint_every_puts=10 ** 9,
                      docstore_backend="native",
                      mirror_backend=mirror_backend)
    data = _unit_rows(rng, DURABLE_ROWS + 1000, cfg.vector_dim)
    queries = _unit_rows(rng, 32, cfg.vector_dim)
    keys = [f"d{i}" for i in range(len(data))]
    acked = [7, DURABLE_ROWS - 1, DURABLE_ROWS + 3, len(data) - 1]
    deleted = list(range(0, 500, 5))
    mmap = mirror_backend == "mmap"
    out = {"rows": len(data)}
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT)
    try:
        eng = tt.VectorDBEngine(cfg, data_dir=work)
        check_native(eng, label)
        assert eng.put_rows(keys[:DURABLE_ROWS], data[:DURABLE_ROWS]).success
        t0 = time.perf_counter()
        ckpt = eng.save_checkpoint()
        out["checkpoint_s"] = time.perf_counter() - t0
        if mmap and not _linked(eng, ckpt):
            raise AssertionError("the checkpoint copied the mirror files "
                                 "instead of hardlinking them")
        assert eng.put_rows(keys[DURABLE_ROWS:], data[DURABLE_ROWS:]).success
        for i in deleted:
            assert eng.delete(keys[i]).success
        want = eng.search_batch(queries, 10)
        n = eng.count()
        eng.wal.close()  # crash: the writer thread joins, no checkpoint
        for how in ("WAL tail replay", "close() checkpoint"):
            t0 = time.perf_counter()
            eng = tt.VectorDBEngine(cfg, data_dir=work)
            got = eng.search_batch(queries, 10)
            out[f"reopen_s {how}"] = time.perf_counter() - t0
            check_native(eng, label)
            assert eng.count() == n, (how, eng.count(), n)
            assert got[1] == want[1], how
            assert np.array_equal(got[0], want[0]), how
            for i in acked:
                r = eng.get(keys[i])
                assert r.success and np.array_equal(
                    np.asarray(r.vector_data.vector, np.float32),
                    data[i]), (how, keys[i])
            assert not any(eng.get(keys[i]).success for i in deleted), how
            if mmap and not _linked(eng, eng.ckpts.latest()):
                raise AssertionError(f"{how}: the reopen copied the "
                                     "checkpoint's mirror files")
            log(f"{label} after {how}: {n} docs, identical results, "
                f"acknowledged writes back, deleted keys gone"
                + (", mirror files hardlinked" if mmap else ""))
            eng.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"{label}: " + json.dumps(out))
    return out


# --------------------------------------------------------------- phase 3b

# a load-generator process: http.client, json and numpy only (msgpack for
# the binary wire); it never imports torch or the port, so the GIL and the
# card stay the server's
_CLIENT_SRC = r'''
import http.client, json, sys, time
import numpy as np

cfg = json.loads(sys.argv[1])
rng = np.random.default_rng(cfg["seed"])
d, n, op = cfg["dim"], cfg["count"], cfg["op"]
rows = cfg.get("batch", 1) * n
x = rng.standard_normal((rows, d), dtype=np.float32)
x /= np.linalg.norm(x, axis=1, keepdims=True)
conn = http.client.HTTPConnection("127.0.0.1", cfg["port"], timeout=300)
if cfg.get("binary"):
    import msgpack

    CT = "application/x-tpuvdb-bin"

    def _default(o):
        return msgpack.ExtType(1, msgpack.packb(
            [o.dtype.str, list(o.shape), o.tobytes()], use_bin_type=True))

    def _ext(code, data):
        dt, shape, raw = msgpack.unpackb(data, raw=False)
        return np.frombuffer(raw, dtype=np.dtype(dt)).reshape(shape)

    def call(method, params):
        conn.request("POST", "/rpc/" + method,
                     msgpack.packb(params, use_bin_type=True,
                                   default=_default),
                     {"Content-Type": CT, "Accept": CT})
        return msgpack.unpackb(conn.getresponse().read(), raw=False,
                               ext_hook=_ext, strict_map_key=False)
else:
    def call(method, params):
        conn.request("POST", "/rpc/" + method, json.dumps(params),
                     {"Content-Type": "application/json"})
        return json.loads(conn.getresponse().read())

lat, out = [], []
t0 = time.time()
for i in range(n):
    if op == "api_search":
        texts = cfg["texts"]
        t = time.perf_counter()
        conn.request("POST", "/api/search",
                     json.dumps({"text": texts[i % len(texts)], "topk": 10}),
                     {"Content-Type": "application/json"})
        r = json.loads(conn.getresponse().read())
        lat.append(time.perf_counter() - t)
        if "results" not in r:
            raise SystemExit(f"api_search failed: {r}")
        if cfg.get("keep"):
            out.append([[h["key"] for h in r["results"]],
                        [float(h["score"]) for h in r["results"]]])
        continue
    if op == "search":
        p = {"query_vector": x[i].tolist(), "top_k": 10}
    elif op == "search_batch":
        b = cfg["batch"]
        q = x[i * b:(i + 1) * b]
        p = {"query_vectors": q if cfg.get("binary") else q.tolist(),
             "top_k": 10}
    else:
        p = {"key": cfg["prefix"] + str(i), "vector": x[i].tolist()}
    t = time.perf_counter()
    r = call(op, p)
    lat.append(time.perf_counter() - t)
    if not r.get("success"):
        raise SystemExit(f"{op} failed: {r.get('message')}")
    if op == "put":
        out.append(p["key"])
    elif cfg.get("keep"):
        sr = r["search_result"]
        out.append([sr["keys"], [float(s) for s in sr["scores"]]])
print(json.dumps({"lat": lat, "t0": t0, "t1": time.time(), "out": out}))
'''


def _unit_seeded(seed: int, n: int, d: int) -> np.ndarray:
    """The rows a client process of seed `seed` generates."""
    return _unit_rows(np.random.default_rng(seed), n, d)


def _run_clients(port: int, specs: list) -> list:
    """Start one client process per spec (all together) and return their
    parsed outputs in order; any failing client fails the phase, and every
    process is stopped before this returns."""
    procs = []
    try:
        for spec in specs:
            # output into files: a pipe left unread could stall a client
            so, se = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", _CLIENT_SRC,
                 json.dumps(dict(spec, port=port))], stdout=so, stderr=se),
                so, se))
        outs = []
        for p, so, se in procs:
            p.wait(timeout=600)
            so.seek(0)
            se.seek(0)
            if p.returncode != 0:
                raise AssertionError(f"client failed (rc {p.returncode}): "
                                     f"{se.read()[-2000:]}")
            outs.append(json.loads(so.read().strip().splitlines()[-1]))
        return outs
    finally:
        for p, so, se in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            so.close()
            se.close()


def _window(outs: list) -> dict:
    """Latency percentiles over every request of the clients, and the
    requests over the window from the first start to the last end."""
    lat = np.concatenate([o["lat"] for o in outs]) * 1e3
    span = max(o["t1"] for o in outs) - min(o["t0"] for o in outs)
    return {"requests": int(lat.size), "window_s": span,
            "qps": lat.size / span,
            "p50_ms": float(np.percentile(lat, 50)),
            "p90_ms": float(np.percentile(lat, 90))}


def _server_p50s(svc) -> dict:
    snap = svc.engine.timers.snapshot()
    return {name: snap[name]["p50_ms"] for name in
            ("service.search", "service.batcher_wait", "search.device")
            if name in snap}


def _open_service(cfg, data_dir):
    from tpuvdb_torch.api.server import DBServer
    from tpuvdb_torch.api.service import DBService

    svc = DBService(cfg, data_dir=data_dir)
    srv = DBServer(svc, port=0)
    srv.start_background()
    return svc, srv


def _check_profile_trace(svc, srv, queries) -> dict:
    """/rpc/profile from a handler thread while another client searches:
    the torch.profiler trace must hold the scan kernels that the batcher's
    thread launched."""
    from tpuvdb_torch.api.client import DBClient

    stop = threading.Event()

    def load():
        c = DBClient(srv.address, timeout=120)
        i = 0
        while not stop.is_set():
            c.call("search", {"query_vector": queries[i % len(queries)]
                              .tolist(), "top_k": 10})
            i += 1
        c.close()
        return i

    work = tempfile.mkdtemp(prefix="chip_smoke_trace_", dir=ROOT)
    try:
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(load)
            r = DBClient(srv.address, timeout=120).call(
                "profile", {"log_dir": work, "seconds": 1.0})
            stop.set()
            searches = fut.result(timeout=120)
        assert r["success"], r
        with open(os.path.join(work, "trace.json")) as f:
            trace = f.read()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    n_scan = trace.count("scan_kernel")
    if n_scan == 0:
        raise AssertionError("the /rpc/profile trace names no scan kernel")
    return {"searches_meanwhile": searches, "scan_kernel_mentions": n_scan,
            "trace_bytes": len(trace)}


def phase_serve(tt, scan, engine_out: dict) -> dict:
    """The reference's server at real size (see the module docstring)."""
    from tpuvdb_torch.api.client import DBClient
    from tpuvdb_torch.utils.tracing import StageTimer

    import importlib.util as ilu

    have = {m: ilu.find_spec(m) is not None for m in ("msgpack", "click")}
    log(f"serve: msgpack imports: {have['msgpack']}, click imports: "
        f"{have['click']}")
    binary = have["msgpack"]
    if not binary:
        log("serve: msgpack does not import here: the b32 / b256 "
            "search_batch windows run on the JSON wire")
    rng = np.random.default_rng(0)               # the engine phase's rows
    cfg = tt.DBConfig(vector_dim=512, search_coalesce=True)
    d = cfg.vector_dim
    data = _unit_rows(rng, SERVE_ROWS, d)
    keys = [f"doc{i}" for i in range(SERVE_ROWS)]
    out = {"rows": SERVE_ROWS, "msgpack": have["msgpack"],
           "click": have["click"], "mirror_backend": cfg.mirror_backend}
    work = tempfile.mkdtemp(prefix="chip_smoke_serve_", dir=ROOT)
    try:
        # build through the engine (WAL on), checkpoint, close. One
        # put_rows call: each call past checkpoint_every_puts (2,000) or
        # compact_every_puts (200,000) runs a checkpoint or a compaction of
        # every mirror row, so chunks would cost one of each per chunk
        t0 = time.perf_counter()
        eng = tt.VectorDBEngine(cfg, data_dir=work)
        assert eng.put_rows(keys, data).success
        eng.flush()
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.save_checkpoint()
        out["checkpoint_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.close()
        out["close_s"] = time.perf_counter() - t0
        del eng
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        svc, srv = _open_service(cfg, work)
        out["reopen_s"] = time.perf_counter() - t0
        assert svc.engine.count() == SERVE_ROWS
        check_native(svc.engine, "serve")
        t0 = time.perf_counter()
        svc.engine.search_batch(data[:1], 10)
        torch.cuda.synchronize()
        out["first_search_s"] = time.perf_counter() - t0
        log(f"serve: {SERVE_ROWS} rows written through the engine (WAL on, "
            f"one put_rows) in {out['build_s']:.3f} s, "
            f"checkpoint {out['checkpoint_s']:.3f} s, close (another "
            f"checkpoint) {out['close_s']:.3f} s, DBService reopen "
            f"{out['reopen_s']:.3f} s, first search (index upload) "
            f"{out['first_search_s']:.3f} s")
        port = srv.port
        launches0 = scan.LAUNCHES

        # one client, JSON wire
        svc.engine.timers = StageTimer()
        seed = 101
        o = _run_clients(port, [{"op": "search", "seed": seed, "dim": d,
                                 "count": SERVE_ONE_CLIENT, "keep": True}])
        one = _window(o)
        one["server_p50_ms"] = _server_p50s(svc)
        one["engine_b1_p50_ms"] = engine_out["b1"]["p50_ms"]
        qs = _unit_seeded(seed, SERVE_ONE_CLIENT, d)
        got_k = np.array([r[0] for r in o[0]["out"]], dtype=object)
        got_d = np.array([r[1] for r in o[0]["out"]], np.float64)
        dd, kk = svc.engine.search_batch(qs, 10)
        want_k = np.array([[k for k in row if k is not None][:10]
                           for row in kk], dtype=object)
        want_d = np.asarray(dd, np.float64)[:, :10]
        tol = RESCORE_RTOL * ((qs * qs).sum(1) + 1.0) + RESCORE_ATOL
        apart, alld = _tie_mismatches(got_k, want_k, want_d, tol)
        same = got_k == want_k
        derr = float(np.abs(got_d - want_d)[same].max())
        one.update(key_mismatches_apart_from_ties=apart,
                   key_mismatches=alld, max_score_err=derr)
        if apart or derr > float(tol.max()):
            raise AssertionError(f"served answers differ from the engine's: "
                                 f"{apart} ids apart from ties, score error "
                                 f"{derr}")
        truth = _exact_truth(data, qs)
        one["recall_at_10"] = _recall(got_k.tolist(), truth, keys)
        if one["recall_at_10"] < RECALL_MIN:
            raise AssertionError(f"served recall@10 {one['recall_at_10']} "
                                 f"< {RECALL_MIN}")
        out["one_client"] = one
        log("serve one client, /rpc/search k=10, JSON: " + json.dumps(one))

        # 16 client processes, closed loop
        svc.engine.timers = StageTimer()
        l0 = scan.LAUNCHES
        o = _run_clients(port, [{"op": "search", "seed": 200 + i, "dim": d,
                                 "count": SERVE_CLIENT_REQS}
                                for i in range(SERVE_CLIENTS)])
        many = _window(o)
        many["scan_launches"] = scan.LAUNCHES - l0
        many["requests_per_scan_launch"] = (
            many["requests"] / max(1, many["scan_launches"]))
        many["server_p50_ms"] = _server_p50s(svc)
        out["clients_16"] = many
        log(f"serve {SERVE_CLIENTS} client processes, /rpc/search k=10: "
            + json.dumps(many))

        # 8 client processes, search_batch b32
        svc.engine.timers = StageTimer()
        g0 = dict(svc.engine.info()["search_groups"])
        o = _run_clients(port, [{"op": "search_batch", "seed": 300 + i,
                                 "dim": d, "batch": SERVE_BATCH,
                                 "count": SERVE_BATCH_REQS,
                                 "binary": binary}
                                for i in range(SERVE_BATCH_CLIENTS)])
        b32 = _window(o)
        b32["wire"] = "binary" if binary else "json"
        b32["qps_queries"] = b32["qps"] * SERVE_BATCH
        g1 = svc.engine.info()["search_groups"]
        b32["search_groups"] = {n: c - g0.get(n, 0) for n, c in g1.items()
                                if c - g0.get(n, 0)}
        out["b32_clients_8"] = b32
        log(f"serve {SERVE_BATCH_CLIENTS} client processes, "
            f"/rpc/search_batch b{SERVE_BATCH}: " + json.dumps(b32))

        # one client, search_batch b256, on each wire there is
        b256 = {"engine_b256_p50_ms": engine_out["b256"]["p50_ms"]}
        for wire in (("json", "binary") if binary else ("json",)):
            o = _run_clients(port, [{"op": "search_batch", "seed": 400,
                                     "dim": d, "batch": 256,
                                     "count": SERVE_B256_REQS,
                                     "binary": wire == "binary"}])
            b256[wire] = _window(o)
            b256[wire]["over_engine_ms"] = (
                b256[wire]["p50_ms"] - b256["engine_b256_p50_ms"])
        out["b256_one_client"] = b256
        log("serve one client, /rpc/search_batch b256: " + json.dumps(b256))

        # writes while searching: 16 put clients beside 16 search clients
        svc.engine.timers = StageTimer()
        specs = [{"op": "put", "seed": 500 + i, "dim": d,
                  "count": SERVE_PUTS, "prefix": f"w{i}_"}
                 for i in range(SERVE_PUT_CLIENTS)]
        specs += [{"op": "search", "seed": 600 + i, "dim": d,
                   "count": SERVE_MIXED_REQS}
                  for i in range(SERVE_CLIENTS)]
        o = _run_clients(port, specs)
        puts, searches = o[:SERVE_PUT_CLIENTS], o[SERVE_PUT_CLIENTS:]
        mixed = {"puts": _window(puts), "searches": _window(searches),
                 "server_p50_ms": _server_p50s(svc)}
        acked = {}
        for i, po in enumerate(puts):
            vecs = _unit_seeded(500 + i, SERVE_PUTS, d)
            for j, key in enumerate(po["out"]):
                acked[key] = vecs[int(key.split("_")[1])]
        assert len(acked) == SERVE_PUT_CLIENTS * SERVE_PUTS, len(acked)

        c = DBClient(srv.address, timeout=120)  # a connection per thread

        def check_key(item):
            key, vec = item
            g = c.call("get", {"key": key})
            s = c.call("search", {"query_vector": vec.tolist(), "top_k": 1})
            return (g["success"] and np.array_equal(
                np.asarray(g["vector_data"]["vector"], np.float32), vec),
                s["search_result"]["keys"])

        with ThreadPoolExecutor(8) as pool:
            res = list(pool.map(check_key, acked.items()))
        bad = [k for (ok, top), k in zip(res, acked) if not ok]
        not_top = [k for (ok, top), k in zip(res, acked) if top[0] != k]
        if bad or not_top:
            raise AssertionError(f"acknowledged puts: {len(bad)} do not read "
                                 f"back, {len(not_top)} are not the top-1 of "
                                 f"their own vector ({(bad + not_top)[:5]})")
        mixed["acked_puts"] = len(acked)
        out["writes_while_searching"] = mixed
        log("serve writes while searching: " + json.dumps(mixed)
            + f"; all {len(acked)} acknowledged puts read back equal and "
            "are the top-1 of their own vector")

        client = DBClient(srv.address, timeout=120)
        victims = list(acked)[::len(acked) // SERVE_DELETES][:SERVE_DELETES]
        for key in victims:
            assert client.call("delete", {"key": key})["success"], key
        for key in victims:
            assert not client.call("get", {"key": key})["success"], key
            top = client.call("search", {"query_vector": acked[key].tolist(),
                                         "top_k": 10})["search_result"]
            assert key not in top["keys"], key
        for key in victims:
            del acked[key]
        log(f"serve: {len(victims)} /rpc/delete, each gone from get and "
            "from the top-10 of its own vector")

        out["profile"] = _check_profile_trace(svc, srv, qs)
        log("serve /rpc/profile from a handler thread: "
            + json.dumps(out["profile"]))
        out["scan_launches"] = scan.LAUNCHES - launches0
        out["batcher_fallbacks"] = svc.rpc_info({})["info"][
            "batcher_fallbacks"]
        if out["batcher_fallbacks"] != 0:
            raise AssertionError(f"{out['batcher_fallbacks']} batcher "
                                 "fallbacks")
        check_native(svc.engine, "serve")

        # restart: close and reopen the service
        n = svc.engine.count()
        t0 = time.perf_counter()
        srv.shutdown()
        svc.close()
        out["restart_close_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        svc, srv = _open_service(cfg, work)
        out["restart_reopen_s"] = time.perf_counter() - t0
        client = DBClient(srv.address, timeout=120)
        assert svc.engine.count() == n, (svc.engine.count(), n)
        for key, vec in list(acked.items())[::4]:
            g = client.call("get", {"key": key})
            assert g["success"] and np.array_equal(
                np.asarray(g["vector_data"]["vector"], np.float32), vec), key
        for key in victims:
            assert not client.call("get", {"key": key})["success"], key
        top = client.call("search", {"query_vector": next(iter(
            acked.values())).tolist(), "top_k": 1})["search_result"]
        assert top["keys"] == [next(iter(acked))], top["keys"]
        check_native(svc.engine, "serve after restart")
        log(f"serve restart at {n} rows: close {out['restart_close_s']:.3f}"
            f" s, reopen {out['restart_reopen_s']:.3f} s; count equal, "
            "acknowledged puts back, deleted keys gone")
        srv.shutdown()
        svc.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    if have["click"]:
        out["cli_serve"] = _check_cli_serve()
    else:
        log("serve: click does not import here: the `python3 -m "
            "tpuvdb_torch.api.cli serve` subprocess check is left out")
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _check_cli_serve() -> dict:
    """`python3 -m tpuvdb_torch.api.cli serve --data-dir D --port P` as a
    subprocess (64-d): /healthz, a put, a search, and a clean exit on
    SIGTERM."""
    import http.client
    import signal

    from tpuvdb_torch.api.client import DBClient

    port = _free_port()
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=ROOT)
    env = dict(os.environ, TPUVDB_VECTOR_DIM="64")
    logf = tempfile.TemporaryFile("w+")

    def tail():
        logf.seek(0)
        return logf.read()[-3000:]

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpuvdb_torch.api.cli", "serve", "--port",
         str(port), "--data-dir", os.path.join(work, "db")], cwd=ROOT,
        env=env, stdout=logf, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 180
        while True:
            if proc.poll() is not None:
                raise AssertionError("serve died: " + tail())
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=2)
                conn.request("GET", "/healthz")
                if conn.getresponse().status == 200:
                    break
            except (OSError, http.client.HTTPException):
                pass
            if time.monotonic() > deadline:
                raise AssertionError("serve never answered /healthz")
            time.sleep(0.2)
        up_s = time.perf_counter() - t0
        v = _unit_rows(np.random.default_rng(9), 1, 64)[0]
        c = DBClient(f"127.0.0.1:{port}", timeout=120)
        assert c.call("put", {"key": "cli", "vector": v.tolist()})["success"]
        r = c.call("search", {"query_vector": v.tolist(), "top_k": 1})
        assert r["success"] and r["search_result"]["keys"] == ["cli"], r
        info = c.call("info", {})["info"]
        assert info["device"].startswith("cuda"), info["device"]
        c.close()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        if rc != 0:
            raise AssertionError(f"serve exited {rc} on SIGTERM: " + tail())
        ckpts = os.listdir(os.path.join(work, "db", "checkpoints"))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        logf.close()
        shutil.rmtree(work, ignore_errors=True)
    if not ckpts:
        raise AssertionError("serve left no checkpoint on SIGTERM")
    res = {"healthy_after_s": up_s, "exit_code": rc}
    log("serve subprocess (python3 -m tpuvdb_torch.api.cli serve): "
        + json.dumps(res) + "; put, search, clean exit on SIGTERM with a "
        "final checkpoint")
    return res


def phase_federation(tt) -> dict:
    """A FederatedCoordinator behind a DBServer over two node services on
    the card (see the module docstring)."""
    from tpuvdb_torch.api.client import DBClient
    from tpuvdb_torch.api.server import DBServer
    from tpuvdb_torch.cluster.federation import FederatedCoordinator

    d = 512
    cfg = tt.DBConfig(vector_dim=d)
    rng = np.random.default_rng(11)
    data = _unit_rows(rng, FED_ROWS + FED_DOWN_PUTS, d)
    keys = [f"f{i}" for i in range(len(data))]
    queries = _unit_rows(rng, FED_QUERIES, d)
    dirs = [tempfile.mkdtemp(prefix=f"chip_smoke_fed{i}_", dir=ROOT)
            for i in range(2)]
    nodes = [_open_service(cfg, w) for w in dirs]
    coord = FederatedCoordinator(tt.DBConfig(vector_dim=d))
    csrv = DBServer(coord, port=0)
    csrv.start_background()
    out = {"rows": FED_ROWS, "replica_count": cfg.replica_count}
    try:
        for i, (_, srv) in enumerate(nodes):
            coord.register_node(f"n{i}", srv.address)

        cc = DBClient(csrv.address, timeout=120)  # a connection per thread

        def put(i):
            r = cc.call("put", {"key": keys[i], "vector": data[i].tolist()})
            assert r["success"], r

        def wait_held(svc, n):
            deadline = time.monotonic() + 120
            while svc.engine.count() < n:
                if time.monotonic() > deadline:
                    raise AssertionError(f"a node holds {svc.engine.count()}"
                                         f" of {n} keys")
                time.sleep(0.05)

        def node_gets(srv, idx):
            nc = DBClient(srv.address, timeout=120)

            def one(i):
                g = nc.call("get", {"key": keys[i]})
                return g["success"] and np.array_equal(np.asarray(
                    g["vector_data"]["vector"], np.float32), data[i])

            with ThreadPoolExecutor(8) as pool:
                return sum(pool.map(one, idx))

        def coord_recall(rows):
            truth = _exact_truth(data[:rows], queries)
            c = DBClient(csrv.address, timeout=120)
            got = [c.call("search", {"query_vector": q.tolist(), "top_k": 10})
                   ["search_result"]["keys"] for q in queries]
            return _recall(got, truth, keys)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(put, range(FED_ROWS)))
        out["puts_s"] = time.perf_counter() - t0
        for svc, _ in nodes:
            wait_held(svc, FED_ROWS)
        out["replicated_s"] = time.perf_counter() - t0
        for i, (_, srv) in enumerate(nodes):
            held = node_gets(srv, range(FED_ROWS))
            if held != FED_ROWS:
                raise AssertionError(f"node n{i} holds {held} of {FED_ROWS}")
        out["recall_at_10"] = coord_recall(FED_ROWS)
        if out["recall_at_10"] < RECALL_MIN:
            raise AssertionError(f"federated recall {out['recall_at_10']}")
        log(f"federation: {FED_ROWS} puts through the coordinator in "
            f"{out['puts_s']:.3f} s, on both nodes after "
            f"{out['replicated_s']:.3f} s (direct /rpc/get on each, vectors "
            f"equal); coordinator recall@10 {out['recall_at_10']:.4f}")

        # one node down: the replica answers
        down_svc, down_srv = nodes[1]
        down_srv.shutdown()
        coord.registry.check_health_once()
        assert not coord.registry.get_node("n1").online
        c = DBClient(csrv.address, timeout=120)
        for i in range(0, FED_ROWS, 10):
            g = c.call("get", {"key": keys[i]})
            assert g["success"] and np.array_equal(np.asarray(
                g["vector_data"]["vector"], np.float32), data[i]), keys[i]
        out["recall_at_10_one_down"] = coord_recall(FED_ROWS)
        if out["recall_at_10_one_down"] < RECALL_MIN:
            raise AssertionError("recall with a node down "
                                 f"{out['recall_at_10_one_down']}")
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(put, range(FED_ROWS, FED_ROWS + FED_DOWN_PUTS)))
        log(f"federation, n1 down: every 10th key gets from the replica, "
            f"recall@10 {out['recall_at_10_one_down']:.4f}; "
            f"{FED_DOWN_PUTS} more puts")

        # reopen n1 from its data_dir and sync it
        down_svc.close()
        t0 = time.perf_counter()
        nodes[1] = _open_service(cfg, dirs[1])
        out["node_reopen_s"] = time.perf_counter() - t0
        coord.register_node("n1", nodes[1][1].address)
        t0 = time.perf_counter()
        r = c.call("sync", {"node_id": "n1"})
        assert r["success"], r
        out["sync_s"] = time.perf_counter() - t0
        out["sync"] = r["message"]
        total = FED_ROWS + FED_DOWN_PUTS
        held = node_gets(nodes[1][1], range(total))
        if held != total:
            raise AssertionError(f"reopened n1 holds {held} of {total}")
        check_native(nodes[1][0].engine, "federation node")
        log(f"federation: n1 reopened from its data_dir in "
            f"{out['node_reopen_s']:.3f} s, synced in {out['sync_s']:.3f} s "
            f"({r['message']}); its gets match all {total} keys")
    finally:
        csrv.shutdown()
        coord.close()
        for svc, srv in nodes:
            srv.shutdown()
            svc.close()
        for w in dirs:
            shutil.rmtree(w, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- clip


def tower_flops(tokens: int, width: int, layers: int) -> float:
    """Operations (2 a multiply-add) of one sequence through a tower's
    blocks: the qkv and out projections (4 W^2 a token), the MLP (8 W^2)
    and the attention's two products (2 T^2 W)."""
    return layers * (24.0 * tokens * width * width
                     + 4.0 * tokens * tokens * width)


def host_p50(fn, reps: int) -> float:
    """Median host-clock time of one fn() call after a warm one, in ms."""
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return float(np.median(times)) * 1e3


def _clip_towers() -> tuple:
    """The full-width ViT-B/32 embedder on the card (seed 0): init time
    and device bytes, each tower's p50 at its batches, and its embeddings
    of two texts and two pixel batches against the same towers' CPU
    forward."""
    from tpuvdb_torch.embed.clip import CLIPConfig, CLIPEmbedder, _l2n

    cfg = CLIPConfig()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    emb = CLIPEmbedder(cfg, seed=0)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "device_bytes": torch.cuda.memory_allocated() - m0,
           "params": {name: sum(p.numel() for p in m.parameters())
                      for name, m in (("text", emb.text_model),
                                      ("image", emb.vision_model))}}
    log(f"clip: ViT-B/32 towers (embed_dim {cfg.embed_dim}, seed 0) built "
        f"on the card in {out['init_s']:.3f} s, {out['params']} "
        f"parameters, {out['device_bytes']} device bytes")
    s = cfg.image_size
    rng = np.random.default_rng(0)
    texts = [f"{CLIP_TEXTS[i % len(CLIP_TEXTS)]} {i}"
             for i in range(max(CLIP_BATCHES_TEXT))]
    tokens = torch.from_numpy(emb.tokenize(texts)).cuda().long()
    pixels = torch.from_numpy(rng.standard_normal(
        (max(CLIP_BATCHES_IMAGE), s, s, 3), dtype=np.float32)).cuda()
    per = {"text": tower_flops(cfg.context_length, cfg.text_width,
                               cfg.text_layers),
           "image": tower_flops((s // cfg.patch_size) ** 2 + 1,
                                cfg.vision_width, cfg.vision_layers)}
    out["gflop_per_item"] = {k: v / 1e9 for k, v in per.items()}
    for name, batches, fn in (
            ("text", CLIP_BATCHES_TEXT,
             lambda b: emb.text_features(tokens[:b])),
            ("image", CLIP_BATCHES_IMAGE,
             lambda b: emb.image_features(pixels[:b]))):
        out[name] = {}
        for b in batches:
            ms = cuda_ms(lambda: fn(b), CLIP_REPS, warmup=3, median=True)
            out[name][f"b{b}"] = {"p50_ms": ms,
                                  "tflops": tflops(b * per[name], ms)}
    log("clip tower p50s (CUDA events, f32): " + json.dumps(
        {k: out[k] for k in ("text", "image", "gflop_per_item")}))

    t0 = time.perf_counter()
    cpu = CLIPEmbedder(cfg, seed=0, device="cpu")
    out["cpu_init_s"] = time.perf_counter() - t0
    same = all(torch.equal(a.cpu(), b) for m, c in (
        (emb.text_model, cpu.text_model), (emb.vision_model, cpu.vision_model))
        for a, b in zip(m.state_dict().values(), c.state_dict().values()))
    if not same:
        raise AssertionError("the seeded towers differ between the card "
                             "and the CPU")
    two = list(CLIP_TEXTS[:2])
    errs = [np.abs(emb.text2vec_batch(two) - cpu.text2vec_batch(two)).max()]
    for _ in range(2):
        batch = rng.standard_normal((2, s, s, 3), dtype=np.float32)
        errs.append(np.abs(_l2n(emb.image_features(batch).cpu().numpy())
                           - _l2n(cpu.image_features(batch).numpy())).max())
    out["card_vs_cpu_max_abs_err"] = float(max(errs))
    del cpu
    log(f"clip: card against the CPU forward of the same towers (2 texts, "
        f"2 pixel batches of 2, unit embeddings): max |diff| "
        f"{out['card_vs_cpu_max_abs_err']:.3e} (atol {CLIP_ATOL}); the "
        f"seeded weights are equal bit for bit")
    if out["card_vs_cpu_max_abs_err"] > CLIP_ATOL:
        raise AssertionError("the card's embeddings differ from the CPU's "
                             f"beyond {CLIP_ATOL}")
    return emb, out


def _cli(args: list, timeout: float = 300) -> str:
    """`python3 -m tpuvdb_torch.api.cli ARGS` from the checkout; its
    output, or an error with it."""
    proc = subprocess.run([sys.executable, "-m", "tpuvdb_torch.api.cli"]
                          + args, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"cli {args[:3]} exited {proc.returncode}: "
                             f"{(proc.stdout + proc.stderr)[-3000:]}")
    return proc.stdout


def _clip_pngs(svc, srv, emb, work: str) -> dict:
    """PNG files through the service's put_image and the CLI's
    ingest-images (remote: the CLI process embeds them on the card), then
    the CLI's text-search; each file's own vector finds it first."""
    from PIL import Image

    from tpuvdb_torch.api.client import DBClient

    rng = np.random.default_rng(7)
    dirs = [os.path.join(work, n) for n in ("put_image", "ingest_images")]
    paths = []
    for i in range(CLIP_PNGS):
        d = dirs[i * 2 // CLIP_PNGS]
        os.makedirs(d, exist_ok=True)
        p = os.path.join(d, f"png_{i}.png")
        Image.fromarray(rng.integers(0, 256, (200 + 24 * i, 300, 3),
                                     np.uint8)).save(p)
        paths.append(p)
    out = {}
    t0 = time.perf_counter()
    for p in paths[:CLIP_PNGS // 2]:
        r = svc.put_image(p, dataset="png")
        assert r["success"], r
    out["put_image_s"] = time.perf_counter() - t0
    addr = ["--coord-addr", srv.address]
    t0 = time.perf_counter()
    text = _cli(addr + ["ingest-images", dirs[1], "--dataset", "cli"])
    out["cli_ingest_s"] = time.perf_counter() - t0
    want = f"ingested {CLIP_PNGS - CLIP_PNGS // 2}/{CLIP_PNGS - CLIP_PNGS // 2}"
    if want not in text:
        raise AssertionError(f"cli ingest-images: {text[-500:]}")
    t0 = time.perf_counter()
    text = _cli(addr + ["text-search", "-k", "5", CLIP_TEXTS[0]])
    out["cli_text_search_s"] = time.perf_counter() - t0
    shown = [line.split("|")[1].strip() for line in text.splitlines()[2:]
             if "|" in line]
    expect = [r["key"] for r in svc.text_search(CLIP_TEXTS[0], 5)["results"]]
    if shown != expect:
        raise AssertionError(f"cli text-search shows {shown}, the service "
                             f"answers {expect}")
    c = DBClient(srv.address, timeout=120)
    worst = 0.0
    for p in paths:
        r = c.call("search", {"query_vector": emb.image2vec(p).tolist(),
                              "top_k": 1})["search_result"]
        if r["keys"] != [os.path.basename(p)]:
            raise AssertionError(f"{p}: its own vector finds {r['keys']}")
        worst = max(worst, r["scores"][0])
    out["own_vector_max_score"] = worst
    if worst >= 1e-3:
        raise AssertionError(f"a PNG's own vector scores {worst}")
    log("clip PNG files (Pillow): " + json.dumps(out) + f"; {CLIP_PNGS // 2} "
        "through put_image, the rest through `cli ingest-images` (another "
        "process embedding on the card), `cli text-search` shows the "
        "service's answer, each file's own vector finds it first")
    return out


def phase_clip_e2e() -> dict:
    """bench/clip_e2e.py at its full shape (see the module docstring)."""
    from tpuvdb_torch.bench import clip_e2e

    t0 = time.perf_counter()
    r = clip_e2e.run(E2E_N, E2E_DIM, E2E_BATCH, E2E_K)
    out = {k: r[k] for k in ("line", "stages_ms", "init_s", "corpus_s",
                             "tower_params", "corpus_bytes")}
    idx, dist = r["idx"], r["dist"]
    if idx.shape != (E2E_BATCH, E2E_K) or not np.isfinite(dist).all():
        raise AssertionError(f"clip_e2e: top-k of shape {idx.shape}, "
                             "finite distances expected")
    if ((idx < 0) | (idx >= E2E_N)).any() or (np.diff(dist, axis=1) < 0).any():
        raise AssertionError("clip_e2e: rows out of range or not ascending")
    if any(len(set(row)) != E2E_K for row in idx.tolist()):
        raise AssertionError("clip_e2e: a row repeats in a top-k")
    del r
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log("clip_e2e JSON line: " + json.dumps(out["line"]))
    log("clip_e2e stages, ms a batch of 64 (CUDA events; tokenize on the "
        "host clock): " + json.dumps(out["stages_ms"]))
    return out


def phase_clip(tt, scan) -> dict:
    """Text -> image search served on the card (see the module
    docstring)."""
    from tpuvdb_torch.api.client import DBClient
    from tpuvdb_torch.api.server import DBServer
    from tpuvdb_torch.api.service import DBService
    from tpuvdb_torch.embed import clip
    from tpuvdb_torch.embed.clip import _l2n
    from tpuvdb_torch.kernels.distance import l2sq_topk
    from tpuvdb_torch.utils.tracing import StageTimer

    emb, out = _clip_towers()
    d, s = emb.cfg.embed_dim, emb.cfg.image_size
    cfg = tt.DBConfig(vector_dim=d)
    assert cfg.search_mode == "approx" and cfg.storage_dtype == "float32"
    data = _unit_rows(np.random.default_rng(0), SERVE_ROWS, d)
    keys = [f"doc{i}" for i in range(SERVE_ROWS)]
    svc = DBService(cfg)
    srv = DBServer(svc, port=0)
    srv.start_background()
    work = tempfile.mkdtemp(prefix="chip_smoke_clip_", dir=ROOT)
    try:
        t0 = time.perf_counter()
        assert svc.engine.put_rows(keys, data).success
        del data
        prng = np.random.default_rng(5)
        img_vecs = np.concatenate([_l2n(emb.image_features(prng.standard_normal(
            (32, s, s, 3), dtype=np.float32)).cpu().numpy())
            for _ in range(CLIP_IMAGES // 32)])
        img_keys = [f"clip_img{i}.png" for i in range(CLIP_IMAGES)]
        assert svc.engine.put_rows(img_keys, img_vecs, [
            {"file_path": f"/images/{k}", "dataset": "clip"}
            for k in img_keys]).success
        svc.engine.flush()
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        check_native(svc.engine, "clip")
        log(f"clip: {SERVE_ROWS} unit rows + {CLIP_IMAGES} rows embedded by "
            f"the image tower behind a DBServer in {out['build_s']:.3f} s")

        client = DBClient(srv.address, timeout=300)
        t0 = time.perf_counter()
        first = client.api_search(CLIP_TEXTS[0], 10)
        out["first_api_search_s"] = time.perf_counter() - t0
        assert len(first.get("results", [])) == 10, first
        if svc.embedder is not clip.load_default_embedder(d):
            raise AssertionError("the service did not load the default "
                                 "embedder")
        log(f"clip: first /api/search (loads the service's embedder) "
            f"{out['first_api_search_s']:.3f} s")

        svc.engine.timers = StageTimer()
        scan.LAUNCHES = 0
        o = _run_clients(srv.port, [{"op": "api_search", "seed": 0, "dim": d,
                                     "count": CLIP_ONE_CLIENT, "keep": True,
                                     "texts": list(CLIP_TEXTS)}])
        out["scan_launches"] = scan.LAUNCHES
        log(f"clip: scan launches over the one-client /api/search window: "
            f"{out['scan_launches']} for {CLIP_ONE_CLIENT} requests")
        if out["scan_launches"] != CLIP_ONE_CLIENT:
            raise AssertionError(
                f"{CLIP_ONE_CLIENT} /api/search requests launched the scan "
                f"kernel {out['scan_launches']} times, one each expected")
        one = _window(o)
        one["server_p50_ms"] = _server_p50s(svc)
        served = o[0]["out"]
        nt = len(CLIP_TEXTS)
        if any(r != served[i % nt] for i, r in enumerate(served)):
            raise AssertionError("one text, different answers")
        got_k = np.array([r[0] for r in served[:nt]], dtype=object)
        got_d = np.array([r[1] for r in served[:nt]], np.float64)
        if (np.diff(got_d, axis=1) < 0).any():
            raise AssertionError("/api/search results are not ascending")

        # the smoke's own text2vec, through the engine and the oracles over
        # the same device corpus
        qs = np.stack([emb.text2vec(t) for t in CLIP_TEXTS])
        tol = RESCORE_RTOL * ((qs * qs).sum(1) + 1.0) + RESCORE_ATOL
        idx = svc.engine._index
        key_of = np.vectorize(lambda r: svc.engine.docstore.key_at(
            *idx.layout.shard_slot_of(int(r))), otypes=[object])
        q_t = torch.from_numpy(qs).cuda()
        d_ex, r_ex = l2sq_topk(q_t, idx.vectors, idx.sqnorms, idx.valid, 10,
                               mode="exact")
        d_bk, r_bk = _plain_topk(scan, q_t, idx.vectors, idx.sqnorms,
                                 idx.valid, 10)
        d_ex, d_bk = (x.double().cpu().numpy() for x in (d_ex, d_bk))
        k_ex, k_bk = key_of(r_ex.cpu().numpy()), key_of(r_bk.cpu().numpy())
        dd, kk = svc.engine.search_batch(qs, 10)
        k_en = np.array([row[:10] for row in kk], dtype=object)
        checks = {}
        for name, k_o, d_o in (("engine", k_en, np.asarray(dd, np.float64)),
                               ("bucket_oracle", k_bk, d_bk),
                               ("exact_oracle", k_ex, d_ex)):
            apart, alld = _tie_mismatches(got_k, k_o, d_o[:, :10], tol)
            same = got_k == k_o
            checks[name] = {"key_mismatches_apart_from_ties": apart,
                            "key_mismatches": alld,
                            "max_score_err": float(
                                np.abs(got_d - d_o[:, :10])[same].max())}
        # every served score is its key's exact distance
        ents = [[svc.engine.docstore.get(k) for k in r] for r in got_k]
        rows = torch.tensor([[idx.layout.row_of(e.shard, e.slot) for e in r]
                             for r in ents], device=q_t.device)
        exact = ((idx.vectors[rows] - q_t[:, None]) ** 2).sum(-1)
        checks["served_scores_vs_exact_max_err"] = float(
            np.abs(exact.double().cpu().numpy() - got_d).max())
        one["recall_at_10"] = float(np.mean(
            [len(set(a) & set(b)) / 10 for a, b in zip(got_k, k_ex)]))
        one["checks"] = checks
        out["one_client"] = one
        log("clip one client, /api/search k=10: " + json.dumps(one))
        for name in ("engine", "bucket_oracle", "exact_oracle"):
            c = checks[name]
            if (c["key_mismatches_apart_from_ties"]
                    or c["max_score_err"] > float(tol.max())):
                raise AssertionError(f"/api/search against the {name}: {c}")
        if checks["served_scores_vs_exact_max_err"] > float(tol.max()):
            raise AssertionError("/api/search scores are not their keys' "
                                 "exact distances")
        if one["recall_at_10"] < RECALL_MIN:
            raise AssertionError(f"/api/search recall@10 "
                                 f"{one['recall_at_10']} < {RECALL_MIN}")

        # an embedded image's own vector finds it first
        r = client.call("search_batch", {"query_vectors": img_vecs.tolist(),
                                         "top_k": 1})
        assert r["success"], r
        tops = [(res["keys"][0], res["scores"][0]) for res in r["results"]]
        bad = [k for k, (got, _) in zip(img_keys, tops) if got != k]
        out["image_own_vector_max_score"] = max(sc for _, sc in tops)
        if bad or out["image_own_vector_max_score"] >= 1e-3:
            raise AssertionError(f"image rows not first for their own "
                                 f"vector: {bad[:5]}, max score "
                                 f"{out['image_own_vector_max_score']}")
        log(f"clip: each of the {CLIP_IMAGES} image rows is the top-1 of its "
            f"own vector (max score "
            f"{out['image_own_vector_max_score']:.3e})")

        # where a text search's time goes, in process
        t = CLIP_TEXTS[3]
        q = emb.text2vec(t)
        out["stages_p50_ms"] = {
            "tokenize": host_p50(lambda: emb.tokenize([t]), CLIP_STAGE_REPS),
            "text_tower_b1_device": out["text"]["b1"]["p50_ms"],
            "text2vec": host_p50(lambda: emb.text2vec(t), CLIP_STAGE_REPS),
            "engine_search_hits": host_p50(
                lambda: svc.engine.search_hits(q, 10), CLIP_STAGE_REPS),
            "service_text_search": host_p50(
                lambda: svc.text_search(t, 10), CLIP_STAGE_REPS),
            "client_api_search": one["p50_ms"],
        }
        log("clip text-search stages, p50 ms: "
            + json.dumps(out["stages_p50_ms"]))
        out["png"] = _clip_pngs(svc, srv, emb, work)
        out["batcher_fallbacks"] = svc.rpc_info({})["info"][
            "batcher_fallbacks"]
        if out["batcher_fallbacks"]:
            raise AssertionError(f"{out['batcher_fallbacks']} batcher "
                                 "fallbacks")
    finally:
        srv.shutdown()
        svc.close()
        shutil.rmtree(work, ignore_errors=True)
    del svc, emb
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 3c


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def _bench_scan_suite(scan, ivf_probe) -> dict:
    """`cli bench --suite scan` in this process, stdout captured, the
    launch counts zeroed just before and read just after."""
    from tpuvdb_torch.api import cli

    buf = io.StringIO()
    scan.LAUNCHES = 0
    ivf_probe.LAUNCHES_EXPANDED = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.cli.main(["--device", "cuda", "bench", "--suite", "scan"],
                     standalone_mode=False)
    wall = time.perf_counter() - t0
    launches = {"scan_candidates": scan.LAUNCHES,
                "ivf_candidates": ivf_probe.LAUNCHES_EXPANDED}
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    stages, last = lines[:-1], lines[-1]
    for stage in stages:
        log("bench stage " + json.dumps(stage))
    log("bench scan JSON line: " + json.dumps(last))
    names = [stage["stage"] for stage in stages]
    if names != list(BENCH_PATHS) + ["engine", "ivf"]:
        raise AssertionError(f"bench --suite scan: stage lines {names}")
    if set(last) != BENCH_SCAN_KEYS:
        raise AssertionError(f"bench --suite scan: last line keys "
                             f"{sorted(last)}")
    if last["capacity_pq"] is not None:
        raise AssertionError("bench --suite scan: capacity_pq is not null")
    if last["corpus"] != [1_000_000, 128]:
        raise AssertionError(f"bench --suite scan: corpus {last['corpus']}")
    for path, ref in BENCH_ROUND5_RECALL.items():
        got = last["paths"][path]["recall_at_10"]
        log(f"bench recall@10 {path}: {got} (the reference's round 5 on the "
            f"same corpus: {ref}; floor {ref - BENCH_RECALL_SLACK:.4f})")
        if got < ref - BENCH_RECALL_SLACK:
            raise AssertionError(f"bench {path}: recall@10 {got} below "
                                 f"{ref - BENCH_RECALL_SLACK:.4f}")
    engine = last["engine"]
    if not engine["engine_recall_at_10"] >= RECALL_MIN:
        raise AssertionError(f"bench engine: recall@10 "
                             f"{engine['engine_recall_at_10']}")
    if not BENCH_IVF_KEYS <= set(engine):
        raise AssertionError(f"bench engine: IVF keys missing from "
                             f"{sorted(engine)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"bench --suite scan never launched {name}")
    return {"wall_s": wall, "stages": stages, "line": last,
            "launches": launches}


def _bench_hold_scan(scan, corpus_np, queries_np) -> dict:
    """The scan kernel against its plain twin on the bench's padded bf16
    corpus at Q = 256 and 512 (d = 128), and its times."""
    from tpuvdb_torch.bench import scan as scan_bench

    dev = torch.device("cuda")
    padded, sq_np, valid_np = scan_bench.padded_arrays(corpus_np)
    x = torch.from_numpy(padded).to(dev).to(torch.bfloat16)
    s = torch.from_numpy(sq_np).to(dev)
    v = torch.from_numpy(valid_np).to(dev)
    m = torch.zeros(v.shape, device=dev).masked_fill_(~v, scan.NEG_INF)
    queries = torch.from_numpy(queries_np).to(dev)
    n_pad, d = x.shape
    rows, err = [], 0.0
    for nq in BENCH_HOLD_QS:
        q = queries[:nq]
        err = max(err, _hold(scan, f"bench bf16 Q={nq} N={n_pad} d={d}",
                             q, x, s, m, v))
        ms = cuda_ms(lambda: scan.scan_candidates(q, x, s, m, BUCKETS), 10)
        plain_ms = cuda_ms(
            lambda: scan.scan_candidates_plain(q, x, s, m, BUCKETS), 3, 1)
        lib_ms = cuda_ms(lambda: _library_topk(q, x, s, 10), 3, 1)
        work = scan_work(nq, n_pad, d, torch.bfloat16)
        bound, by, route = _bound(work, torch.bfloat16)
        row = {"dtype": "bfloat16", "Q": nq, "N": n_pad, "d": d, "ms": ms,
               "tflops": tflops(work["ops"], ms), "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
               "bound_route": route}
        rows.append(row)
        log("bench kernel timing " + json.dumps(row))
    del x, s, v, m, queries
    torch.cuda.empty_cache()
    return {"rows": rows, "max_abs_err": err}


def _bench_hold_probe(ivf_probe, corpus_np, queries_np) -> dict:
    """The f32 IVF probe against its plain twin at the bench's IVF shape:
    an IVFIndex over the same rows (nlist 1024, nprobe 64, 6 k-means
    iterations on 131,072 rows), b8; and its times."""
    from tpuvdb_torch.index.ivf import IVFIndex

    dev = torch.device("cuda")
    n, d = corpus_np.shape
    t0 = time.perf_counter()
    idx = IVFIndex.build(corpus_np, np.ones(n, bool), nlist=1024, nprobe=64,
                         kmeans_iters=6, train_sample=131072)
    torch.cuda.synchronize()
    log(f"bench ivf index: {n} x {d} in {time.perf_counter() - t0:.1f} s, "
        f"nlist {idx.nlist}, cell_pad {idx.cell_pad}")
    mask = torch.zeros(idx.grouped_valid.shape, device=dev).masked_fill_(
        ~idx.grouped_valid, ivf_probe.NEG_INF)
    q = torch.from_numpy(queries_np[:BENCH_PROBE_Q]).to(dev)
    plan = ivf_probe.probe_plan(q, idx.centroids, idx.cell_offsets,
                                idx.cell_pad, 10, 64)
    if plan.compact:
        raise AssertionError("bench ivf: the b8 plan took the compact form")
    name = f"bench expanded float32 Q={BENCH_PROBE_Q} nprobe=64 d={d}"
    g, sq = idx.grouped, idx.grouped_sq
    err = _hold_probe(ivf_probe, name, plan, g, sq, mask)
    ms = cuda_ms(lambda: ivf_probe.plan_candidates(plan, g, sq, mask), 20)
    plain_ms = cuda_ms(lambda: ivf_probe.plan_candidates(
        plan, g, sq, mask, plain=True), 3, 1)
    work = _plan_work(ivf_probe, plan, g.shape[0] // 128, d, g.element_size())
    bound, by, route = _bound(work, torch.float32)
    row = {"form": "expanded", "dtype": "float32", "Q": BENCH_PROBE_Q,
           "nprobe": 64, "d": d, "ms": ms, "tflops": tflops(work["ops"], ms),
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "bound_route": route, **work}
    log("bench ivf kernel timing " + json.dumps(row))
    del idx, g, sq, mask, plan
    torch.cuda.empty_cache()
    return {"row": row, "max_abs_err": err}


def phase_bench(scan, ivf_probe) -> dict:
    """`bench --suite scan` through the CLI in this process, the two
    kernels it runs held against their plain twins at its shapes, then
    `bench --suite streaming` as a CLI process (see the module
    docstring)."""
    from tpuvdb_torch.bench import scan as scan_bench

    t0 = time.perf_counter()
    out = {"scan": _bench_scan_suite(scan, ivf_probe)}
    corpus_np, queries_np, _ = scan_bench.load_corpus(log=log)
    out["hold_scan"] = _bench_hold_scan(scan, corpus_np, queries_np)
    out["hold_probe"] = _bench_hold_probe(ivf_probe, corpus_np, queries_np)
    del corpus_np

    t1 = time.perf_counter()
    text = _cli(["--device", "cuda", "bench", "--suite", "streaming"],
                timeout=900)
    line = json.loads(text.splitlines()[-1])
    log("bench streaming JSON line: " + json.dumps(line))
    if set(line) != BENCH_STREAMING_KEYS or not line["value"] > 0:
        raise AssertionError(f"bench --suite streaming: {line}")
    out["streaming"] = {"wall_s": time.perf_counter() - t1, "line": line}
    out["phase_s"] = time.perf_counter() - t0
    scan_line, eng = out["scan"]["line"], out["scan"]["line"]["engine"]
    log(f"bench on {_card()}: scan suite {out['scan']['wall_s']:.1f} s, "
        f"streaming suite {out['streaming']['wall_s']:.1f} s, phase "
        f"{out['phase_s']:.1f} s; paths (QPS, recall@10): "
        + json.dumps({p: [r["qps"], r["recall_at_10"]]
                      for p, r in scan_line["paths"].items()})
        + f"; engine single {eng['engine_qps_single']} pipelined "
        f"{eng['engine_qps_pipelined']} QPS, recall "
        f"{eng['engine_recall_at_10']}; ivf p50 {eng['ivf_p50_ms_per_query']}"
        f" ms a query (b8), build {eng['ivf_build_s']} s; ingest "
        f"{line['value']} vec/s, concurrent search p50 "
        f"{line['concurrent_search_p50_ms']} ms, recovery "
        f"{line['recovery_s']} s")
    return out


# ------------------------------------------------------------ capacity phase


def _run_bench(module, argv: list, phase: str = "capacity") -> dict:
    """module.main(argv, device="cuda") in this process with its stdout
    and stderr captured (stderr is echoed after): its JSON lines, stderr,
    seconds and what main returned. What it left on the card is freed
    after, and the anonymous RSS logged."""
    from tpuvdb_torch.utils.hostmem import anon_gb

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            returned = module.main(argv, device="cuda")
    finally:
        sys.stderr.write(err.getvalue())
    wall = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    name = module.__name__.rsplit(".", 1)[-1]
    log(f"{phase} phase: {name} {' '.join(argv)} took {wall:.1f} s; "
        f"anonymous RSS after it {anon_gb():.2f} GB (hostmem.anon_gb; -1 "
        f"where /proc/self/smaps_rollup is missing), {_status_rss()}")
    return {"lines": [json.loads(line) for line in
                      out.getvalue().splitlines()],
            "stderr": err.getvalue(), "wall_s": wall, "returned": returned}


def _status_rss() -> str:
    """The resident-set lines of /proc/self/status (RssAnon, VmRSS)."""
    with open("/proc/self/status") as f:
        return ", ".join(" ".join(line.split()) for line in f
                         if line.startswith(("RssAnon:", "VmRSS:")))


def _near_centroids(index, nq: int, seed: int) -> torch.Tensor:
    """nq queries on the index's device: centroids drawn by a seeded
    generator, plus 5% of their spread in gaussian noise."""
    gen = torch.Generator(device=index.device).manual_seed(seed)
    pick = torch.randint(0, index.nlist, (nq,), generator=gen,
                         device=index.device)
    c = index.centroids[pick]
    noise = torch.randn(c.shape, generator=gen, device=index.device)
    return c + 0.05 * c.std() * noise


def _capacity_latency(scan, ivf_probe) -> dict:
    """bench/latency.py at its defaults, three times; the scan's and the
    f32 probe's launches zeroed before each run and read after."""
    from tpuvdb_torch.bench import latency

    out = {}
    for mode, index in LATENCY_RUNS:
        scan.LAUNCHES = 0
        ivf_probe.LAUNCHES_EXPANDED = 0
        run = _run_bench(latency, ["--mode", mode, "--index", index])
        launches = {"scan_candidates": scan.LAUNCHES,
                    "ivf_candidates": ivf_probe.LAUNCHES_EXPANDED}
        lines = run["lines"]
        if [line.get("metric") for line in lines] != [
                f"search_latency_b{b}" for b in (1, 8, 64)]:
            raise AssertionError(f"latency {mode}/{index}: lines {lines}")
        for line in lines:
            if set(line) != LATENCY_KEYS or not line["value"] > 0 or (
                    line["mode"], line["index"]) != (mode, index):
                raise AssertionError(f"latency {mode}/{index}: {line}")
        if mode == "approx" and index == "flat" and \
                launches["scan_candidates"] <= 0:
            raise AssertionError("latency --mode approx never launched the "
                                 "scan kernel")
        if index == "ivf" and launches["ivf_candidates"] <= 0:
            raise AssertionError("latency --index ivf never launched the f32 "
                                 "probe kernel")
        for line in lines:
            log("capacity latency JSON line " + json.dumps(line))
        log(f"capacity latency {mode}/{index}: launches "
            f"{json.dumps(launches)}")
        out[f"{mode}/{index}"] = {"lines": lines, "wall_s": run["wall_s"],
                                  "launches": launches}
    return out


def _capacity_raw(rows: int) -> dict:
    from tpuvdb_torch.bench import capacity

    run = _run_bench(capacity, ["--rows", str(rows)])
    line = run["lines"][-1]
    log("capacity JSON line " + json.dumps(line))
    if set(line) != CAPACITY_KEYS:
        raise AssertionError(f"capacity: keys {sorted(line)}")
    for path in ("int8_resc_b128", "int8_resc_b256"):
        if not line[path]["recall"] >= RECALL_MIN:
            raise AssertionError(f"capacity {path}: recall "
                                 f"{line[path]['recall']}")
    log(f"capacity plain int8 recall@10 (reported): b128 "
        f"{line['int8_b128']['recall']}, b256 {line['int8_b256']['recall']}")
    return {"line": line, "wall_s": run["wall_s"]}


def _capacity_engine(rows: int) -> dict:
    from tpuvdb_torch.bench import capacity_engine

    run = _run_bench(capacity_engine, ["--rows", str(rows)])
    line = run["lines"][-1]
    log("capacity_engine JSON line " + json.dumps(line))
    if set(line) != CAPACITY_ENGINE_KEYS or line["rows"] != rows:
        raise AssertionError(f"capacity_engine: {line}")
    if not line["recall_at_10"] >= RECALL_MIN:
        raise AssertionError(f"capacity_engine: recall "
                             f"{line['recall_at_10']}")
    if line["restart_s"] is None:
        raise AssertionError("capacity_engine: no restart")
    log(f"capacity_engine on {_card()}: device {line['device_gib']} GiB, "
        f"ingest {line['ingest_rows_per_s']} rows/s, build "
        f"{line['build_s']} s, QPS single {line['engine_qps_single']} x8 "
        f"{line['engine_qps_pipelined']}, checkpoint {line['checkpoint_s']}"
        f" s, restart {line['restart_s']} s (count {rows}, asserted)")
    return {"line": line, "wall_s": run["wall_s"]}


def _capacity_ivf(ivf_probe, rows: int, args: tuple = (),
                  keep: str = None) -> dict:
    """capacity_ivf.py at `rows` (`args` beside them); with `keep` its
    corpus and oracle are cached there ($TPUVDB_BENCH_CACHE) and the index
    it built is written there as diag_ivf_b1's cached index."""
    from tpuvdb_torch.bench import capacity_ivf, diag_ivf_b1
    from tpuvdb_torch.index.ivf import IVFIndex

    ivf_probe.LAUNCHES_EXPANDED_INT8 = 0
    before = os.environ.get("TPUVDB_BENCH_CACHE")
    if keep:
        os.environ["TPUVDB_BENCH_CACHE"] = keep
    try:
        run = _run_bench(capacity_ivf, ["--rows", str(rows), *args])
    finally:
        if before is None:
            os.environ.pop("TPUVDB_BENCH_CACHE", None)
        else:
            os.environ["TPUVDB_BENCH_CACHE"] = before
    launches = ivf_probe.LAUNCHES_EXPANDED_INT8
    line = run["lines"][-1]
    log("capacity_ivf JSON line " + json.dumps(line))
    if set(line) != CAPACITY_IVF_KEYS or line["rows"] != rows:
        raise AssertionError(f"capacity_ivf: {line}")
    sweep = {int(n): float(r) for n, r in re.findall(
        r"^nprobe (\d+): recall@10 ([0-9.]+)$", run["stderr"], re.M)}
    if list(sweep) != [8, 16, 32, 64, 128, 256]:
        raise AssertionError(f"capacity_ivf: sweep {sweep}")
    # the reference's rule: the first nprobe at recall 0.95, else the last
    reached = [n for n, r in sweep.items() if r >= RECALL_MIN]
    chosen = reached[0] if reached else max(sweep)
    if line["nprobe"] != chosen or line["recall_at_10"] != round(
            sweep[chosen], 4):
        raise AssertionError(f"capacity_ivf: measured at nprobe "
                             f"{line['nprobe']}, the sweep {sweep} chooses "
                             f"{chosen}")
    log(f"capacity_ivf recall@10 sweep {json.dumps(sweep)}: "
        + (f"{RECALL_MIN} reached at nprobe {chosen}" if reached else
           f"no nprobe of the reference's sweep reaches {RECALL_MIN} on "
           f"this data at {rows} rows (TARGET MISSED: best "
           f"{sweep[chosen]} at nprobe {chosen}, over {line['nlist']} "
           f"cells after the build's bisection); measured there, as the "
           f"reference's script does"))
    if launches <= 0:
        raise AssertionError("capacity_ivf never launched the int8 probe")
    _, idx = run.pop("returned")
    if keep:
        t0 = time.perf_counter()
        with open(os.path.join(keep, "capacity_ivf.json"), "w") as f:
            f.write(json.dumps(line))
        np.savez(os.path.join(keep, diag_ivf_b1.index_file_name(
            line["rows"], line["dim"], 4096)),
            **IVFIndex.packed_fetch(idx.packed_capture()))
        log(f"capacity_ivf: index kept for diag_ivf_b1 in "
            f"{time.perf_counter() - t0:.1f} s")
    mask = torch.zeros(idx.grouped_valid.shape, device=idx.device
                       ).masked_fill_(~idx.grouped_valid, ivf_probe.NEG_INF)
    rows_out = []
    for nq in CAPACITY_HOLD_QS["capacity_ivf"]:
        q = _near_centroids(idx, nq, seed=13)
        plan = ivf_probe.probe_plan(q, idx.centroids, idx.cell_offsets,
                                    idx.cell_pad, 10, line["nprobe"])
        if plan.compact:
            raise AssertionError(f"capacity_ivf Q={nq}: the compact form")
        rows_out.append(_int8_case(ivf_probe, plan, idx, mask, nq,
                                   line["nprobe"], label="capacity "))
    del idx, mask
    torch.cuda.empty_cache()
    return {"line": line, "wall_s": run["wall_s"], "launches": launches,
            "kernel": rows_out,
            "max_abs_err": max(r["max_abs_err"] for r in rows_out)}


def _capacity_pq(pq_probe, rows: int, sm_clocks: float,
                 args: tuple = (), keep: str = None) -> dict:
    """capacity_pq.py at `rows` with its defaults, or `args` beside them
    (with `keep`, its data dir is kept at keep/pq); then the PQ probe
    against its twin on the index the bench ends with (the restarted
    engine's)."""
    from tpuvdb_torch.bench import capacity_pq

    pq_probe.LAUNCHES_PQ = 0
    kept = ["--data-dir", os.path.join(keep, "pq")] if keep else []
    with tempfile.TemporaryDirectory() as tmp:
        # kept, the file holds the stages the bench finished even when a
        # check below fails: the diagnostic reads what it served
        out_file = os.path.join(keep or tmp, "capacity_pq.json")
        run = _run_bench(capacity_pq, ["--rows", str(rows), *args, *kept,
                                       "--out", out_file])
        with open(out_file) as f:
            written = json.loads(f.read())
    launches = pq_probe.LAUNCHES_PQ
    line = run["lines"][-1]
    log("capacity_pq JSON line " + json.dumps(line))
    # the holds first: they report whatever the checks below find
    _, idx = run.pop("returned")
    rows_out = []
    for nq in CAPACITY_HOLD_QS["capacity_pq"]:
        row = _hold_pq_index(pq_probe, idx, _near_centroids(idx, nq, 17),
                             line["nprobe"], "capacity index",
                             20 if nq <= 32 else 5, sm_clocks)
        rows_out.append({**row, "Q": nq, "nprobe": line["nprobe"]})
    del idx
    torch.cuda.empty_cache()
    if set(line) != CAPACITY_PQ_KEYS or line["rows"] != rows:
        raise AssertionError(f"capacity_pq: keys {sorted(line)}")
    if written != line or line["stage"] != "complete":
        raise AssertionError("capacity_pq: --out does not hold the last line")
    if not line["recall_at_10"] >= RECALL_MIN:
        raise AssertionError(f"capacity_pq: served recall "
                             f"{line['recall_at_10']}")
    if launches <= 0:
        raise AssertionError("capacity_pq never launched the PQ probe")
    if set(line["kernel_probe"]) != {"b32", "b256"}:
        raise AssertionError(f"capacity_pq: kernel_probe "
                             f"{line['kernel_probe']}")
    serving = line["serving_by_batch"]
    if set(serving) != {"32", "256"} or not min(
            min(v) for v in serving.values()) > 0:
        raise AssertionError(f"capacity_pq: serving {serving}")
    if line["restart_s"] is None:
        raise AssertionError("capacity_pq: no restart")
    (split,) = [json.loads(x[len("build split: "):]) for x in
                run["stderr"].splitlines() if x.startswith("build split: ")]
    log(f"capacity_pq on {_card()} ({' '.join(args) or 'its defaults'}): "
        f"served recall@10 "
        f"{line['recall_at_10']} at nprobe {line['nprobe']} (this data's "
        f"recall in the reference's record of 8M rows at nprobe 16, an "
        f"earlier revision of its code: {CAPACITY_PQ_DATA_RECALL}); build "
        f"{line['build_s']} s, split "
        f"{json.dumps(split)}; restart {line['restart_s']} s "
        f"{json.dumps(line['restart_split'])} (count {rows}, asserted)")
    return {"line": line, "wall_s": run["wall_s"], "launches": launches,
            "build_split": split, "kernel": rows_out,
            "max_abs_err": max(r["max_abs_err"] for r in rows_out)}


def _capacity_examples() -> dict:
    """quickstart as a process in a temporary working directory, then
    sharded_serving on four slots of the card in this process."""
    from tpuvdb_torch.examples import sharded_serving

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        proc = subprocess.run(
            [sys.executable, "-m", "tpuvdb_torch.examples.quickstart"],
            cwd=work, env={**os.environ, "PYTHONPATH": ROOT},
            capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"quickstart exited {proc.returncode}: "
                             f"{(proc.stdout + proc.stderr)[-3000:]}")
    hits = [x.split()[0] for x in proc.stdout.splitlines()
            if x.startswith("  img_")]
    log("quickstart: " + " | ".join(proc.stdout.splitlines()))
    if not hits or hits[0] != "img_01234.jpg":
        raise AssertionError(f"quickstart: first hits {hits}")
    quick_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sharded_serving.main(devices=["cuda:0"] * MESH_SLOTS)
    log("sharded_serving: " + " | ".join(out.getvalue().splitlines()))
    if "self-retrieval: 64/64" not in out.getvalue():
        raise AssertionError("sharded_serving: self-retrieval below 64/64")
    gc.collect()
    torch.cuda.empty_cache()
    return {"quickstart_s": quick_s,
            "sharded_serving_s": time.perf_counter() - t0}


def capacity_benches(ivf_probe, pq_probe, sm_clocks: float, rows: dict,
                     pq_args: tuple = (), ivf_args: tuple = (),
                     keep: str = None) -> dict:
    """The capacity benches named in `rows`, in its order, each at its
    --rows (capacity_pq with `pq_args` beside them, capacity_ivf with
    `ivf_args`); with `keep`, capacity_ivf's cache and index and
    capacity_pq's data dir are kept there for the diagnostics."""
    run = {"capacity": _capacity_raw,
           "capacity_engine": _capacity_engine,
           "capacity_ivf": lambda n: _capacity_ivf(ivf_probe, n,
                                                   tuple(ivf_args), keep),
           "capacity_pq": lambda n: _capacity_pq(pq_probe, n, sm_clocks,
                                                 tuple(pq_args), keep)}
    return {name: run[name](n) for name, n in rows.items()}


def capacity_alone(rows: int, benches=tuple(CAPACITY_ROWS),
                   pq_args: tuple = (), ivf_args: tuple = (),
                   diag: bool = False) -> dict:
    """The capacity benches alone, each at `rows` rows, after the builds
    they need; every check of the capacity phase holds. At the benches'
    own 8,000,000 rows the four take about 33 minutes:
    python3 -c 'import chip_smoke; chip_smoke.capacity_alone(8_000_000)'
    capacity_pq's served recall misses 0.95 there at the reference's
    re-rank window (640 = 10 x k); the reference's record of 16M rows
    widens it to 1,280 (docs/BENCH_PQ16M_r5.json, "window_tune"):
    capacity_alone(8_000_000, ["capacity_pq"],
                   pq_args=["--overfetch", "128"])
    With `diag` each diagnostic follows its bench, on what the bench kept:
    diag_pq_recall on capacity_pq's data dir (its recall grid, nprobe x
    overfetch), diag_ivf_b1 on capacity_ivf's cached corpus and index:
    capacity_alone(8_000_000, ["capacity_pq"], diag=True)
    capacity_alone(10_000_000, ["capacity_ivf"], ivf_args=["--dim", "96"],
                   diag=True)"""
    sys.path.insert(0, ROOT)
    from tpuvdb_torch.kernels import ivf_probe, pq_probe, scan

    libs = (scan.LIBRARY, ivf_probe.LIBRARY, pq_probe.LIBRARY)
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        host = pool.submit(build_native)
        list(pool.map(lambda lib: lib.load(), libs))
        host.result()
    sm_clocks = (torch.cuda.get_device_properties(0).multi_processor_count
                 * _sm_clock_hz())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_keep_",
                                     dir=ROOT) as keep:
        try:
            out = capacity_benches(ivf_probe, pq_probe, sm_clocks,
                                   {name: rows for name in benches},
                                   pq_args, ivf_args, keep if diag else None)
        finally:
            # the diagnostics read what the benches kept, also where a
            # bench's own check failed after it: they diagnose such misses
            if diag:
                diagnosed = ops_diagnostics(ivf_probe, pq_probe, keep,
                                            tuple(pq_args))
            log(_card())
    out["diag"] = diagnosed if diag else None
    return out


def phase_capacity(scan, ivf_probe, pq_probe, sm_clocks: float,
                   keep: str) -> dict:
    """The latency and capacity benches and the examples (see the module
    docstring); each capacity bench at its CAPACITY_ROWS, capacity_ivf's
    cache and index and capacity_pq's data dir kept in `keep` for the ops
    phase's diagnostics."""
    t0 = time.perf_counter()
    out = {"latency": _capacity_latency(scan, ivf_probe),
           **capacity_benches(ivf_probe, pq_probe, sm_clocks, CAPACITY_ROWS,
                              keep=keep),
           "examples": _capacity_examples()}
    out["phase_s"] = time.perf_counter() - t0
    log(f"capacity phase {out['phase_s']:.1f} s: " + json.dumps(
        {k: round(v["wall_s"], 1) for k, v in out.items()
         if isinstance(v, dict) and "wall_s" in v}))
    return out


# ----------------------------------------------------------------- ops phase


def _nvidia_apps() -> dict:
    """The card's compute processes (nvidia-smi --query-compute-apps: a
    line each) and its memory in use, MiB. In a container whose pids
    nvidia-smi cannot map, every process shows as pid 1 with the card's
    whole memory: the lines count the processes, and only the card's total
    splits between them."""
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True)
    used = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True)
    return {"lines": apps.stdout.strip().splitlines(),
            "used_mib": float(used.stdout.strip().splitlines()[0])}


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


class _ClusterWatch(threading.Thread):
    """Polls a running start_cluster.sh every OPS_POLL_S: each process's
    pidfile (its start) and first /healthz answer, each node's info RPC
    (the first and the last it answered), the coordinator's node list
    (when node0 goes offline), node0's pidfile (the demo removes it as it
    kills node0) and, once every node holds rows, nvidia-smi's compute
    processes."""

    def __init__(self, cluster_dir: str, coord_port: int, base_port: int):
        super().__init__(daemon=True)
        self.dir, self.coord = cluster_dir, f"127.0.0.1:{coord_port}"
        self.nodes = {f"node{i}": f"127.0.0.1:{base_port + i}"
                      for i in range(OPS_NODES)}
        self.t0 = time.perf_counter()
        self.stop = threading.Event()
        self.pids, self.started, self.healthy = {}, {}, {}
        self.first_info, self.last_info = {}, {}
        self.apps = None
        self.node0_gone = self.node0_offline = None

    def _now(self) -> float:
        return time.perf_counter() - self.t0

    def run(self):
        import http.client

        from tpuvdb_torch.api.client import DBClient

        clients = {}
        addrs = {"coordinator": self.coord, **self.nodes}
        while not self.stop.is_set():
            for name, addr in addrs.items():
                pidfile = os.path.join(self.dir, "pids", f"{name}.pid")
                if name not in self.pids and os.path.exists(pidfile):
                    with open(pidfile) as f:
                        text = f.read().strip()
                    if text:
                        self.pids[name] = int(text)
                        self.started[name] = (os.stat(pidfile).st_mtime
                                              - time.time() + self._now())
                if name == "node0" and name in self.pids and \
                        self.node0_gone is None and \
                        not os.path.exists(pidfile):
                    self.node0_gone = self._now()
                if name not in self.pids:
                    continue
                if name not in clients:
                    clients[name] = DBClient(addr, timeout=1.0)
                try:
                    if name == "coordinator":
                        r = clients[name].call("list_nodes", {})
                        self.healthy.setdefault(name, self._now())
                        offline = {n["node_id"] for n in r.get("nodes", [])
                                   if not n["online"]}
                        if "node0" in offline and self.node0_offline is None:
                            self.node0_offline = self._now()
                        continue
                    info = clients[name].call("info", {})["info"]
                except (OSError, http.client.HTTPException, KeyError,
                        ValueError):
                    continue
                self.healthy.setdefault(name, self._now())
                self.first_info.setdefault(name, info)
                self.last_info[name] = info
            if self.apps is None and len(self.last_info) == OPS_NODES and \
                    all(i["device_rows"] > 0 and i["docs"] > 0
                        for i in self.last_info.values()):
                self.apps = _nvidia_apps()
            time.sleep(OPS_POLL_S)


def _search_count(info: dict) -> int:
    return info["latency"].get("search.device", {}).get("count", 0)


def _ops_cluster(device: str = "cuda") -> dict:
    """tpuvdb_torch/scripts/start_cluster.sh demo on the card (a
    coordinator and OPS_NODES serve processes, TPUVDB_DEVICE=cuda), watched
    while it runs; then `stop`."""
    work = tempfile.mkdtemp(prefix="chip_smoke_ops_", dir=ROOT)
    cluster = os.path.join(work, "cluster")
    script = os.path.join(ROOT, "tpuvdb_torch", "scripts",
                          "start_cluster.sh")
    coord_port = _free_port()
    base_port = _free_port_block(OPS_NODES)
    env = dict(os.environ, TPUVDB_CLUSTER_DIR=cluster,
               TPUVDB_COORD_PORT=str(coord_port),
               TPUVDB_NODE_BASE_PORT=str(base_port), TPUVDB_DEVICE=device,
               TPUVDB_PYTHON=sys.executable, PYTHONPATH=ROOT)
    watch = _ClusterWatch(cluster, coord_port, base_port)
    before = _nvidia_apps()
    proc = subprocess.Popen(["bash", script, "demo"], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    watch.t0 = time.perf_counter()
    watch.start()
    lines = []
    try:
        timer = threading.Timer(OPS_DEMO_TIMEOUT, proc.kill)
        timer.start()
        for line in proc.stdout:
            lines.append((watch._now(), line.rstrip("\n")))
        rc = proc.wait()
        timer.cancel()
    finally:
        watch.stop.set()
        watch.join()
        stop = subprocess.run(["bash", script, "stop"], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=60)
        deadline = time.monotonic() + 60
        while any(_pid_alive(p) for p in watch.pids.values()) and \
                time.monotonic() < deadline:
            time.sleep(0.2)
        left = {n: p for n, p in watch.pids.items() if _pid_alive(p)}
        for p in left.values():
            os.kill(p, 9)
        logs = {}
        for name in os.listdir(os.path.join(cluster, "logs")) if \
                os.path.isdir(os.path.join(cluster, "logs")) else ():
            with open(os.path.join(cluster, "logs", name)) as f:
                logs[name] = f.read()[-2000:]
        shutil.rmtree(work, ignore_errors=True)
    out = "\n".join(text for _, text in lines)
    log("ops cluster demo output:\n" + out)
    if rc != 0 or "FAILOVER OK" not in out:
        raise AssertionError(f"start_cluster.sh demo exited {rc}; logs "
                             f"{json.dumps(logs)}")
    # "1 | key3 | -0.000061 | {}": rank, key, distance, metadata
    top1 = re.findall(r"^1\s*\|\s*(\S+)\s*\|\s*-?[0-9.]+\s*\|", out,
                      re.M)
    if top1 != ["key3", "key3"]:
        raise AssertionError(f"demo top-1 before and after the kill: {top1}")
    if left:
        raise AssertionError(f"processes left after stop: {left}")
    if stop.returncode != 0:
        raise AssertionError(f"start_cluster.sh stop exited "
                             f"{stop.returncode}: {stop.stderr}")
    at = {}
    for t, text in lines:
        for mark in ("--- ingesting", "--- search works", "--- killing",
                     "--- every key", "FAILOVER OK", "cluster stopped"):
            if text.startswith(mark):
                at.setdefault(mark, t)
    nodes = {}
    for name in watch.nodes:
        first, last = watch.first_info.get(name), watch.last_info.get(name)
        if last is None:
            raise AssertionError(f"{name} never answered info")
        searches = _search_count(last) - _search_count(first)
        # one card: "cuda" is cuda:0
        on = torch.device(last["device"])
        if not (on.type == device and on.index in (None, 0)
                and last["device_rows"] > 0
                and searches > 0):
            raise AssertionError(
                f"{name}: device {last['device']}, device_rows "
                f"{last['device_rows']}, search.device count "
                f"{_search_count(first)} -> {_search_count(last)}")
        nodes[name] = {
            "pid": watch.pids[name],
            "startup_s": watch.healthy[name] - watch.started[name],
            "docs": last["docs"], "device_rows": last["device_rows"],
            "searches": searches,
            "search_device_p50_ms": last["latency"]["search.device"][
                "p50_ms"]}
    apps = watch.apps
    if apps is None or len(apps["lines"]) < len(before["lines"]) + len(
            nodes):
        raise AssertionError(f"nvidia-smi --query-compute-apps lists "
                             f"{apps} with the nodes up, {before} before: "
                             f"not the {len(nodes)} node processes")
    if watch.node0_gone is None or watch.node0_offline is None:
        raise AssertionError("node0's kill or its offline mark was not seen")
    res = {
        "nodes": nodes,
        "coordinator_startup_s": (watch.healthy["coordinator"]
                                  - watch.started["coordinator"]),
        "kill_to_offline_s": watch.node0_offline - watch.node0_gone,
        "compute_apps": [len(before["lines"]), len(apps["lines"])],
        # the card's memory in use with the nodes up less before, a node
        "node_card_mib": (apps["used_mib"] - before["used_mib"])
        / len(nodes),
        # 8 `put` client processes, one `search`, 8 `get`s after the sleep
        "put_cli_s": (at["--- search works"] - at["--- ingesting"]) / 8,
        "search_cli_s": at["--- killing"] - at["--- search works"],
        "get_cli_s": (at["FAILOVER OK"] - at["--- every key"]) / 8,
        "demo_s": at["cluster stopped"]}
    log("ops cluster on the card: " + json.dumps(res))
    return res


def _free_port_block(n: int) -> int:
    """The first of n consecutive free localhost ports."""
    import socket

    for base in range(_free_port(), 65536 - n):
        socks = []
        try:
            for port in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise AssertionError("no block of free ports")


def _ops_wire(rows: int) -> dict:
    from tpuvdb_torch.bench import wire

    counts = []
    export_all = wire.export_all

    def counted(client, limit=wire.PAGE):
        n = export_all(client, limit)
        counts.append({"binary": client.binary, "limit": limit, "n": n})
        return n

    wire.export_all = counted
    try:
        run = _run_bench(wire, ["--rows", str(rows)], phase="ops")
    finally:
        wire.export_all = export_all
    line = run["lines"][-1]
    log("ops wire JSON line " + json.dumps(line))
    if set(line) != WIRE_KEYS or line["rows"] != rows:
        raise AssertionError(f"wire: {line}")
    timed = [c for c in counts if c["limit"] == wire.PAGE]
    if [(c["binary"], c["n"]) for c in timed] != [(False, rows),
                                                   (True, rows)]:
        raise AssertionError(f"wire: export counts {counts}")
    if not line["sync_all_peak_records"] > 0:
        raise AssertionError(f"wire: sync_all {line}")
    return {"line": line, "wall_s": run["wall_s"], "exports": counts}


def _ops_serving_ab(scan, rows: int) -> dict:
    from tpuvdb_torch.bench import serving_ab

    scan.LAUNCHES = 0
    run = _run_bench(serving_ab, ["--rows", str(rows)], phase="ops")
    launches = scan.LAUNCHES
    line, answers = run["returned"]
    log("ops serving_ab JSON line " + json.dumps(line))
    if list(line["ab"]) != ["b32_direct", "b32_coalesce", "b512_direct",
                            "b512_coalesce"]:
        raise AssertionError(f"serving_ab: {line}")
    ties = {}
    for b in (32, 512):
        d_dir, k_dir = answers[f"b{b}_direct"]
        d_co, k_co = answers[f"b{b}_coalesce"]
        d_dir, d_co = np.asarray(d_dir), np.asarray(d_co)
        diff = [(i, j) for i in range(b) for j in range(10)
                if k_co[i][j] != k_dir[i][j]]
        near = np.abs(d_co - d_dir) <= TOPK_RTOL * np.abs(d_dir)
        if not near.all() or any(d_co[i, j] != d_dir[i, j]
                                 for i, j in diff):
            raise AssertionError(f"serving_ab b{b}: the coalesced answer "
                                 f"differs outside exact ties at {diff}")
        ties[b] = len(diff)
    if launches <= 0:
        raise AssertionError("serving_ab never launched the scan kernel")
    log(f"serving_ab: coalesced keys equal to direct (exact-tie swaps "
        f"{ties}); scan launches {launches}")
    return {"line": line, "wall_s": run["wall_s"], "launches": launches,
            "tie_swaps": ties}


def ops_diagnostics(ivf_probe, pq_probe, keep: str,
                    pq_args: tuple = ()) -> dict:
    """diag_pq_recall on capacity_pq's kept data dir and diag_ivf_b1 on
    capacity_ivf's kept cache, for whichever of the two left them (a bench
    whose own checks failed after it kept them included); the PQ grid at
    the setting capacity_pq served must give its recall unless `pq_args`
    changed its window."""
    from tpuvdb_torch.bench import diag_ivf_b1, diag_pq_recall

    out = {}
    pq_line = os.path.join(keep, "capacity_pq.json")
    if os.path.exists(pq_line):
        with open(pq_line) as f:
            served = json.loads(f.read())
        nprobes = sorted({*OPS_PQ_NPROBES, served["nprobe"]})
        pq_probe.LAUNCHES_PQ = 0
        run = _run_bench(diag_pq_recall, [
            "--data-dir", os.path.join(keep, "pq"), "--rows",
            str(served["rows"]), "--nprobes", ",".join(map(str, nprobes))],
            phase="ops")
        launches = pq_probe.LAUNCHES_PQ
        grid = run["lines"][-1]["results"]
        log("diag_pq_recall JSON line " + json.dumps(run["lines"][-1]))
        at = grid[f"np{served['nprobe']}_ov10"]["recall_at_10"]
        log(f"diag_pq_recall on {_card()} at {served['rows']} rows: the "
            f"served setting (nprobe {served['nprobe']}, window 640) "
            f"{at}, capacity_pq printed {served['recall_at_10']}; PQ probe "
            f"launches {launches}")
        if not pq_args and at != served["recall_at_10"]:
            raise AssertionError(f"diag_pq_recall: {at} at capacity_pq's "
                                 f"setting, which printed "
                                 f"{served['recall_at_10']}")
        if launches <= 0:
            raise AssertionError("diag_pq_recall never launched the PQ "
                                 "probe")
        out["pq_recall"] = {"grid": grid, "launches": launches,
                            "wall_s": run["wall_s"]}
    ivf_line = os.path.join(keep, "capacity_ivf.json")
    if os.path.exists(ivf_line):
        with open(ivf_line) as f:
            line = json.loads(f.read())
        ivf_probe.LAUNCHES_EXPANDED_INT8 = 0
        ivf_probe.LAUNCHES_COMPACT_INT8 = 0
        before = os.environ.get("TPUVDB_BENCH_CACHE")
        os.environ["TPUVDB_BENCH_CACHE"] = keep
        try:
            run = _run_bench(diag_ivf_b1, ["--rows", str(line["rows"]),
                                           "--dim", str(line["dim"])],
                             phase="ops")
        finally:
            if before is None:
                os.environ.pop("TPUVDB_BENCH_CACHE", None)
            else:
                os.environ["TPUVDB_BENCH_CACHE"] = before
        launches = {"expanded": ivf_probe.LAUNCHES_EXPANDED_INT8,
                    "compact": ivf_probe.LAUNCHES_COMPACT_INT8}
        b1 = run["lines"][-1]
        log(f"diag_ivf_b1 on {_card()} JSON line " + json.dumps(b1))
        if "packed index loaded" not in run["stderr"]:
            raise AssertionError("diag_ivf_b1 did not take the kept index")
        log(f"diag_ivf_b1: int8 probe launches {json.dumps(launches)}")
        if launches[b1["base"]["form"]] <= 0:
            raise AssertionError("diag_ivf_b1 never launched the int8 probe")
        out["ivf_b1"] = {"line": b1, "launches": launches,
                         "wall_s": run["wall_s"]}
    return out


def phase_ops(scan, ivf_probe, pq_probe, keep: str) -> dict:
    """The port's ops scripts and the last reference scripts (see the
    module docstring)."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"cluster": _ops_cluster()}
    out["cluster"]["wall_s"] = time.perf_counter() - t0
    out["wire"] = _ops_wire(OPS_WIRE_ROWS)
    out["serving_ab"] = _ops_serving_ab(scan, OPS_AB_ROWS)
    out.update(ops_diagnostics(ivf_probe, pq_probe, keep))
    out["phase_s"] = time.perf_counter() - t0
    log(f"ops phase {out['phase_s']:.1f} s: " + json.dumps(
        {k: round(v["wall_s"], 1) for k, v in out.items()
         if isinstance(v, dict) and "wall_s" in v}))
    return out


# --------------------------------------------------------------- phase 4


def _plan_work(ivf_probe, plan, n_chunks: int, d: int, item: int,
               row_extra: int = 8) -> dict:
    """Rows and bytes this plan's probe needs: per tile its distinct
    chunks (the operations), over all tiles their union (each chunk read
    once, `row_extra` bytes a row beside its d elements: norm and mask,
    and the scale of an int8 row); outputs written once."""
    if plan.compact:
        lists = ivf_probe.packed_chunks(plan.cells, plan.off128, plan.w128,
                                        n_chunks)
    else:
        lists = plan.cells.long()
    lists = torch.sort(lists, dim=1).values
    per_tile = ((lists[:, 1:] != lists[:, :-1]).sum(dim=1) + 1)
    tile_rows = int(per_tile.sum()) * 128
    union_rows = int(torch.unique(lists).numel()) * 128
    qp = plan.queries.shape[0]
    nbytes = (union_rows * (d * item + row_extra) + qp * d * 4
              + qp * 128 * plan.n_segments * 8 + plan.cells.numel() * 4)
    ops = 2.0 * plan.query_tile * tile_rows * d
    return {"tile_rows": tile_rows, "union_rows": union_rows,
            "bytes": nbytes, "ops": ops}


def _hold_probe(ivf_probe, name, plan, g, sq, mask) -> float:
    """Holds one form's kernel against its plain twin on one plan; raises
    on disagreement, returns the largest candidate score difference."""
    val_k, idx_k = ivf_probe.plan_candidates(plan, g, sq, mask)
    val_p, idx_p = ivf_probe.plan_candidates(plan, g, sq, mask, plain=True)
    torch.cuda.synchronize()
    agree = (idx_k == idx_p).float().mean().item()
    x_max = sq.max().sqrt()
    q_norm = plan.queries.norm(dim=1, keepdim=True)
    tol = IVF_SCORE_TOL * (2.0 * q_norm * x_max + x_max * x_max)
    live = val_p > ivf_probe.NEG_INF
    err = torch.where(live, (val_k - val_p).abs(), torch.zeros_like(val_p))
    worst = (err / tol).max().item()
    q_sq = (plan.queries ** 2).sum(dim=1, keepdim=True)
    top_k = q_sq - torch.topk(val_k, 10, dim=1).values
    top_p = q_sq - torch.topk(val_p, 10, dim=1).values
    top_worst = ((top_k - top_p).abs() / tol).max().item()
    log(f"ivf kernel check {name}: slots agree {agree:.6f}, "
        f"max |score diff| {err.max().item():.3e} ({worst:.3f} of tol), "
        f"top-10 distances {top_worst:.3f} of tol")
    if agree < SLOT_AGREE_MIN:
        raise AssertionError(f"{name}: only {agree:.6f} of slots agree")
    if worst > 1.0 or top_worst > 1.0:
        raise AssertionError(f"{name}: scores disagree beyond tolerance")
    return err.max().item()


def _hold_probe_int8(ivf_probe, name, plan, idx8, mask) -> float:
    """Holds one form's int8 kernel against its plain twin on one plan:
    candidate ids and scores must be equal bit for bit. Returns the largest
    score difference (0.0)."""
    args = (plan, idx8.grouped, idx8.grouped_sq, mask)
    val_k, idx_k = ivf_probe.plan_candidates(*args,
                                             cell_scales=idx8.cell_scales)
    val_p, idx_p = ivf_probe.plan_candidates(*args, plain=True,
                                             cell_scales=idx8.cell_scales)
    torch.cuda.synchronize()
    agree = (idx_k == idx_p).float().mean().item()
    err = (val_k - val_p).abs().max().item()
    filled = (idx_k >= 0).float().mean().item()
    log(f"ivf int8 kernel check {name}: slots agree {agree:.6f}, "
        f"max |score diff| {err:.3e}, {filled:.4f} of slots filled")
    if not torch.equal(idx_k, idx_p) or not torch.equal(val_k, val_p):
        raise AssertionError(f"{name}: the int8 kernel and its plain twin "
                             "differ (they must agree bit for bit)")
    if filled <= 0:
        raise AssertionError(f"{name}: no candidate at all")
    return err


def _int8_kernel_cases(ivf_probe, corpus_np, dead, queries, cases) -> dict:
    """The int8 half of the ivf kernel phase: an int8 IVFIndex over the
    same corpus and dead rows, both int8 kernels vs their twins."""
    from tpuvdb_torch.index.ivf import IVFIndex

    t0 = time.perf_counter()
    idx8 = IVFIndex.build(corpus_np, np.ones(IVF_N, bool), nlist=IVF_NLIST,
                          nprobe=IVF_NPROBE, kmeans_iters=6,
                          train_sample=131072, dtype=torch.int8)
    idx8.invalidate_rows(dead)
    torch.cuda.synchronize()
    log(f"ivf int8 kernel index: {IVF_N} x {IVF_D} in "
        f"{time.perf_counter() - t0:.1f} s, nlist {idx8.nlist}, cell_pad "
        f"{idx8.cell_pad}, grouped {tuple(idx8.grouped.shape)} "
        f"{idx8.grouped.dtype}, spill rows {idx8.stats().spill_rows}, "
        f"{idx8.nbytes()} bytes on the device")
    mask = torch.zeros(idx8.grouped_valid.shape,
                       device=idx8.device).masked_fill_(
                           ~idx8.grouped_valid, ivf_probe.NEG_INF)
    w128 = idx8.cell_pad // 128
    rows, err = [], {False: 0.0, True: 0.0}
    for nq, nprobe, force in cases:
        if nq == IVF_COMPACT_Q:  # its own nprobe: just above 2**20 entries
            nprobe = ivf_probe.EXPANDED_MAX // (IVF_COMPACT_Q * w128) + 1
        plan = ivf_probe.probe_plan(queries[:nq], idx8.centroids,
                                    idx8.cell_offsets, idx8.cell_pad, 10,
                                    nprobe, force_compact=force)
        row = _int8_case(ivf_probe, plan, idx8, mask, nq, nprobe)
        err[plan.compact] = max(err[plan.compact], row["max_abs_err"])
        rows.append(row)
    return {"rows": rows, "err_expanded": err[False],
            "err_compact": err[True], "nbytes": idx8.nbytes()}


def _int8_case(ivf_probe, plan, idx8, mask, nq: int, nprobe: int,
               label: str = "") -> dict:
    """One int8 probe plan on `idx8`: the kernel held against its plain
    twin bit for bit, then both timed, with the plan's bound."""
    form = "compact" if plan.compact else "expanded"
    name = f"{label}{form} int8 Q={nq} nprobe={nprobe}"
    err = _hold_probe_int8(ivf_probe, name, plan, idx8, mask)
    reps = 20 if nq <= 8 else 5
    ms = cuda_ms(lambda: ivf_probe.plan_candidates(
        plan, idx8.grouped, idx8.grouped_sq, mask,
        cell_scales=idx8.cell_scales), reps)
    plain_ms = cuda_ms(lambda: ivf_probe.plan_candidates(
        plan, idx8.grouped, idx8.grouped_sq, mask, plain=True,
        cell_scales=idx8.cell_scales), 2, 1)
    n_chunks = idx8.grouped.shape[0] // 128
    work = _plan_work(ivf_probe, plan, n_chunks, idx8.grouped.shape[1], 1,
                      row_extra=12)
    bound, by, route = _bound(work, torch.int8)
    row = {"form": form, "dtype": "int8", "Q": nq, "nprobe": nprobe,
           "ms": ms, "tops": tflops(work["ops"], ms),
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "bound_route": route, "max_abs_err": err, **work}
    log(f"{label}ivf kernel timing " + json.dumps(row))
    return row


def phase_ivf_kernel(ivf_probe) -> dict:
    """All four IVF probe kernels vs their plain twins at full size."""
    from tpuvdb_torch.index.ivf import IVFIndex

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    centers = torch.randn((IVF_NLIST, IVF_D), generator=gen, device=dev) * 3
    assign = torch.randint(0, IVF_NLIST, (IVF_N,), generator=gen, device=dev)
    corpus = centers[assign] + 0.4 * torch.randn((IVF_N, IVF_D),
                                                 generator=gen, device=dev)
    qi = torch.randint(0, IVF_N, (IVF_COMPACT_Q,), generator=gen, device=dev)
    queries = corpus[qi] + 0.05 * torch.randn(
        (IVF_COMPACT_Q, IVF_D), generator=gen, device=dev)
    t0 = time.perf_counter()
    corpus_np = corpus.cpu().numpy()
    del corpus
    idx = IVFIndex.build(corpus_np, np.ones(IVF_N, bool),
                         nlist=IVF_NLIST, nprobe=IVF_NPROBE, kmeans_iters=6,
                         train_sample=131072)
    dead = np.random.default_rng(3).choice(IVF_N, IVF_N // 100,
                                           replace=False)
    idx.invalidate_rows(dead)
    torch.cuda.synchronize()
    log(f"ivf kernel index: {IVF_N} x {IVF_D} in {time.perf_counter() - t0:.1f}"
        f" s, nlist {idx.nlist}, cell_pad {idx.cell_pad}, grouped "
        f"{tuple(idx.grouped.shape)}, spill rows {idx.stats().spill_rows}, "
        f"{len(dead)} dead rows")
    mask = torch.zeros(idx.grouped_valid.shape, device=dev).masked_fill_(
        ~idx.grouped_valid, ivf_probe.NEG_INF)
    n_chunks = idx.grouped.shape[0] // 128
    cells = {torch.float32: idx.grouped,
             torch.bfloat16: idx.grouped.to(torch.bfloat16)}
    w128 = idx.cell_pad // 128
    nprobe_big = ivf_probe.EXPANDED_MAX // (IVF_COMPACT_Q * w128) + 1
    cases = [(q, IVF_NPROBE, fc) for q in IVF_QS for fc in (False, True)]
    cases.append((IVF_COMPACT_Q, nprobe_big, False))
    rows, err = [], {False: 0.0, True: 0.0}
    for dt, g in cells.items():
        for nq, nprobe, force in cases:
            plan = ivf_probe.probe_plan(queries[:nq], idx.centroids,
                                        idx.cell_offsets, idx.cell_pad, 10,
                                        nprobe, force_compact=force)
            form = "compact" if plan.compact else "expanded"
            name = (f"{form} {str(dt).split('.')[-1]} Q={nq} "
                    f"nprobe={nprobe}")
            e = _hold_probe(ivf_probe, name, plan, g, idx.grouped_sq, mask)
            err[plan.compact] = max(err[plan.compact], e)
            reps = 20 if nq <= 8 else 5
            ms = cuda_ms(lambda: ivf_probe.plan_candidates(
                plan, g, idx.grouped_sq, mask), reps)
            plain_ms = cuda_ms(lambda: ivf_probe.plan_candidates(
                plan, g, idx.grouped_sq, mask, plain=True), 2, 1)
            work = _plan_work(ivf_probe, plan, n_chunks, IVF_D,
                              g.element_size())
            bound, by, route = _bound(work, dt)
            row = {"form": form, "dtype": str(dt).split(".")[-1], "Q": nq,
                   "nprobe": nprobe, "ms": ms,
                   "tflops": tflops(work["ops"], ms), "plain_ms": plain_ms,
                   "bound_ms": bound, "bound_by": by, "bound_route": route,
                   **work}
            rows.append(row)
            log("ivf kernel timing " + json.dumps(row))
    f32_bytes = idx.nbytes()
    del cells, idx, mask
    torch.cuda.empty_cache()
    int8 = _int8_kernel_cases(ivf_probe, corpus_np, dead, queries, cases)
    rows += int8["rows"]
    log(f"ivf index on the device: {int8['nbytes']} bytes with int8 cells, "
        f"{f32_bytes} with f32 cells")
    torch.cuda.empty_cache()

    def pick(form, nq, dtype="float32"):
        return next(r for r in rows if r["form"] == form
                    and r["dtype"] == dtype and r["Q"] == nq)

    return {"rows": rows, "expanded": pick("expanded", 256),
            "compact": pick("compact", IVF_COMPACT_Q),
            "expanded_int8": pick("expanded", 256, "int8"),
            "compact_int8": pick("compact", IVF_COMPACT_Q, "int8"),
            "err_expanded": err[False], "err_compact": err[True],
            "err_expanded_int8": int8["err_expanded"],
            "err_compact_int8": int8["err_compact"],
            "nprobe_big": nprobe_big}


# --------------------------------------------------------------- phase 5


def _ivf_config(tt, **kw):
    return tt.DBConfig(vector_dim=IVF_D, index_type="ivf",
                       ivf_nlist=IVF_NLIST, ivf_nprobe=IVF_NPROBE,
                       ivf_kmeans_iters=6, ivf_train_sample=131072,
                       wal_enabled=False, **kw)


def _recall(got_keys, truth_rows, keys) -> float:
    hit = sum(len({keys[r] for r in t} & set(g))
              for g, t in zip(got_keys, truth_rows))
    return hit / (10 * len(truth_rows))


def _exact_truth(data: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Rows of the exact top-10 of each query over the f32 rows."""
    from tpuvdb_torch.kernels.distance import l2sq_topk

    x = torch.from_numpy(data).cuda()
    ones = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    _, truth = l2sq_topk(torch.from_numpy(queries).cuda(), x,
                         (x * x).sum(dim=1), ones, 10, mode="exact")
    truth = truth.cpu().numpy()
    del x
    torch.cuda.empty_cache()
    return truth


def phase_ivf_engine(tt):
    from tpuvdb_torch.bench.datasets import synthetic_corpus

    cfg = _ivf_config(tt)
    assert cfg.shard_count == 4 and cfg.storage_dtype == "float32"
    data, queries = synthetic_corpus(IVF_ENGINE_ROWS, IVF_D, seed=0,
                                     clustered=True)
    keys = [f"r{i}" for i in range(IVF_ENGINE_ROWS)]
    eng = tt.VectorDBEngine(cfg)
    t0 = time.perf_counter()
    assert eng.put_rows(keys, data).success
    eng.flush()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ivf = eng._ivf
    st = ivf.stats()
    log(f"ivf engine build: {IVF_ENGINE_ROWS} rows in {build_s:.3f} s "
        f"(put_rows + flush: k-means, assignment, bisection, packing, "
        f"upload); nlist {st.nlist}, cell_pad {st.cell_pad}, grouped rows "
        f"{st.grouped_rows}, spill rows {st.spill_rows}, fill {st.fill:.4f}")
    out = {"build_s": build_s, "rows": IVF_ENGINE_ROWS,
           "device_bytes": ivf.nbytes(), "stats": dataclasses.asdict(st)}

    _timed_searches(eng, "ivf engine", queries, IVF_BATCHES, out)
    out["b256_device"] = _device_share(eng, queries[:256], "ivf engine")

    # recall@10 against an exact scan of the same rows
    truth = _exact_truth(data, queries)
    _, got = eng.search_batch(queries[:256], 10)
    out["recall_at_10"] = _recall(got, truth[:256], keys)
    log(f"ivf engine recall@10 (b256 vs exact): {out['recall_at_10']:.4f}")
    if out["recall_at_10"] < RECALL_MIN:
        raise AssertionError(f"ivf recall@10 {out['recall_at_10']} < "
                             f"{RECALL_MIN}")
    return eng, data, queries, truth, keys, out


def phase_ivf_index_compact(eng, queries, truth, keys, ivf_probe) -> dict:
    """One IVFIndex.search at b1,024 whose probe set passes 2**20 entries:
    the compact form, on the engine's own index."""
    ivf = eng._ivf
    w128 = ivf.cell_pad // 128
    nprobe = ivf_probe.EXPANDED_MAX // (len(queries) * w128) + 1
    if nprobe > ivf.nlist:
        raise AssertionError(f"nprobe {nprobe} > nlist {ivf.nlist}: no "
                             "probe set of this batch passes 2**20")
    layout = eng._ivf_layout
    _, rows = ivf.search(queries, 10, nprobe=nprobe)
    got = [[eng.docstore.key_at(*layout.shard_slot_of(int(r)))
            for r in row if r >= 0] for row in rows]
    recall = _recall(got, truth, keys)
    log(f"ivf index search b{len(queries)} nprobe {nprobe} "
        f"({len(queries) * nprobe * w128} probe entries > 2**20: compact "
        f"form): recall@10 {recall:.4f}")
    return {"nprobe": nprobe, "recall_at_10": recall}


def phase_ivf_writes(eng, data, queries, label: str = "ivf engine") -> None:
    """Overwrite, delete and get, before and after flush, then a delta
    overflow that drains into the index by append."""
    from tpuvdb_torch.core.types import VectorData

    rng = np.random.default_rng(5)
    rows0 = eng.count()
    probe = data[7] + 0.3 * rng.standard_normal(IVF_D).astype(np.float32)
    assert eng.put(VectorData(key="r5", vector=probe.tolist())).success
    _, k1 = eng.search_batch(queries[1:2], 10)
    victim = k1[0][0]
    assert eng.delete(victim).success
    for when in ("before flush", "after flush"):
        _, kp = eng.search_batch(probe[None], 10)
        assert kp[0][0] == "r5", (when, kp[0][:3])
        _, kv = eng.search_batch(queries[1:2], 10)
        assert victim not in kv[0], (when, victim)
        assert np.allclose(eng.get("r5").vector_data.vector, probe), when
        assert not eng.get(victim).success, when
        eng.flush()
    ivf = eng._ivf
    n_new = eng.config.ivf_delta_max + 16
    fresh = data[:n_new] + 0.2 * rng.standard_normal(
        (n_new, IVF_D)).astype(np.float32)
    appends0 = eng.stats.get("ivf_appends", 0)
    assert eng.put_rows([f"n{i}" for i in range(n_new)], fresh).success
    eng.flush()                       # > ivf_delta_max: drains by append
    _, kn = eng.search_batch(fresh[123:124], 10)
    assert eng._ivf is ivf, "the overflow rebuilt instead of appending"
    appended = eng.stats.get("ivf_appends", 0) - appends0
    assert appended >= n_new and eng.info()["ivf_delta"] == 0, appended
    assert kn[0][0] == "n123", kn[0][:3]
    assert eng.count() == rows0 - 1 + n_new
    log(f"{label} overwrite/delete/get visible before and after flush; "
        f"delta overflow appended {appended} rows in place: ok")


def phase_ivf_restart(tt, label: str = "ivf", packed: bool = False,
                      mesh=None, **kw) -> dict:
    """A 50,000-row data_dir restart: the warm centroids are reused (no
    k-means) and the keys come back identical. With `packed` (an IVF-PQ
    engine) the restart must take the checkpoint's packed file: no codebook
    training, no build at all, ivf_packed_restores == 1. With `mesh` both
    engines run on it, and no shard trains."""
    import tpuvdb_torch.index.ivf as ivf_mod
    import tpuvdb_torch.kernels.pq as pq_mod
    import tpuvdb_torch.mesh.sharded_ivf as sivf_mod
    from tpuvdb_torch.bench.datasets import synthetic_corpus

    cfg = _ivf_config(tt, checkpoint_every_puts=10 ** 9, **kw)
    data, queries = synthetic_corpus(IVF_RESTART_ROWS, IVF_D, seed=9,
                                     clustered=True)
    keys = [f"w{i}" for i in range(IVF_RESTART_ROWS)]
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT)
    real = (ivf_mod.kmeans, sivf_mod.kmeans, pq_mod.train_pq,
            pq_mod.train_opq, ivf_mod.IVFIndex.build_streaming)
    try:
        eng = tt.VectorDBEngine(cfg, data_dir=work, mesh=mesh)
        check_native(eng, f"{label} restart")
        assert eng.put_rows(keys, data).success
        eng.flush()
        cents = eng._ivf.centroids_np().copy()
        want = eng.search_batch(queries[:32], 10)
        eng.close()
        has_file = os.path.exists(os.path.join(eng.ckpts.latest(),
                                               "ivf_packed.npz"))
        assert has_file == packed, "ivf_packed.npz: only IVF-PQ writes it"

        def no_training(*a, **k):
            raise AssertionError("training ran on a warm restart")

        def no_build(*a, **k):
            raise AssertionError("a full build ran on a packed restart")

        ivf_mod.kmeans = sivf_mod.kmeans = no_training
        pq_mod.train_pq = pq_mod.train_opq = no_training
        if packed:
            ivf_mod.IVFIndex.build_streaming = classmethod(no_build)
        t0 = time.perf_counter()
        eng = tt.VectorDBEngine(cfg, data_dir=work, mesh=mesh)
        got = eng.search_batch(queries[:32], 10)
        restart_s = time.perf_counter() - t0
        check_native(eng, f"{label} restart")
        same = sum(g == w for g, w in zip(got[1], want[1]))
        if mesh is None:
            assert np.array_equal(eng._ivf.centroids_np(), cents)
            assert got[1] == want[1], "keys differ after the warm restart"
            assert np.array_equal(got[0], want[0])
        else:
            # a mesh build bisects the warm table's cells again against
            # its own pooled median (the reference's rule), so its cells
            # may move: held to recall, not to identity
            recall = _recall(got[1], _exact_truth(data, queries[:32]), keys)
            log(f"{label} restart: recall@10 {recall:.4f}, {same} of 32 "
                f"queries with the keys of before")
            if recall < RECALL_MIN:
                raise AssertionError(f"{label} restart recall {recall}")
        restores = eng.stats.get("ivf_packed_restores", 0)
        assert restores == int(packed), restores
        how = ("packed file uploaded (no training, no build, "
               "ivf_packed_restores 1)" if packed
               else "warm centroids reused (no k-means)")
        log(f"{label} restart: {IVF_RESTART_ROWS} rows, {how}, reopen + "
            f"first search {restart_s:.3f} s, "
            + ("identical results" if mesh is None
               else f"{same} of 32 queries with identical keys"))
        eng.close()
        return {"rows": IVF_RESTART_ROWS, "restart_s": restart_s,
                "ivf_packed_restores": restores, "same_keys_of_32": same}
    finally:
        (ivf_mod.kmeans, sivf_mod.kmeans, pq_mod.train_pq,
         pq_mod.train_opq, ivf_mod.IVFIndex.build_streaming) = real
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------- the host rescore


def _capture_rescore(eng, queries) -> dict:
    """The host re-rank's inputs in one real search_batch of `queries`:
    the device candidates (rows, and the ADC distances on the adaptive
    IVF-PQ path), the mirrors and the layout the engine handed it."""
    got = {}
    exact, adaptive = eng._rescore_exact, eng._rescore_adaptive

    def exact_spy(q, rows, layout, mirrors, top=None, native=False):
        got.update(q=q, rows=rows, layout=layout, mirrors=mirrors, top=top)
        return exact(q, rows, layout, mirrors, top=top, native=native)

    def adaptive_spy(q, rows, adc, err, k, layout, mirrors, top=None):
        got.update(q=q, rows=rows, adc=adc, err=err, k=k, layout=layout,
                   mirrors=mirrors, top=top)
        return adaptive(q, rows, adc, err, k, layout, mirrors, top=top)

    eng._rescore_exact, eng._rescore_adaptive = exact_spy, adaptive_spy
    try:
        eng.search_batch(queries, 10)
    finally:
        del eng._rescore_exact, eng._rescore_adaptive
    return got


def _tie_mismatches(r_a, r_b, d_b, tol, k: int = 10) -> tuple:
    """(mismatches apart from a tie, all mismatches) of the top-k ids of
    two rankings: a position whose distance in ranking b lies more than
    tol from both neighbours must hold the same id in a and b."""
    dq = d_b[:, :k + 1]
    apart = np.ones((dq.shape[0], k + 2), bool)
    apart[:, 1:dq.shape[1]] = np.abs(np.diff(dq, axis=1)) > tol[:, None]
    sep = apart[:, :k] & apart[:, 1:k + 1] & np.isfinite(dq[:, :k])
    differ = r_a[:, :k] != r_b[:, :k]
    return int((sep & differ).sum()), int(differ.sum())


def _timed(fn):
    """(result, seconds of the fastest of RESCORE_REPS calls)."""
    best, res = float("inf"), None
    for _ in range(RESCORE_REPS):
        t = time.perf_counter()
        res = fn()
        best = min(best, time.perf_counter() - t)
    return res, best


def phase_rescore(eng, queries, label: str) -> dict:
    """The candidate rows of one real b256 search through the native and
    the numpy forms of the engine's exact re-rank, on the same mirrors:
    `_rescore_exact` (the int8 engines' path) and, on the adaptive IVF-PQ
    path, `_exact_masked` over the whole window and `_rescore_adaptive`
    itself. Distances at the same positions within RESCORE_RTOL of |q|^2 +
    max |x|^2 plus RESCORE_ATOL; top-10 ids equal except inside near-ties
    of that width; the adaptive counters equal."""
    from tpuvdb_torch.engine.engine import VectorDBEngine

    cap = _capture_rescore(eng, queries[:256])
    q, rows, layout, mirrors = (cap[k] for k in ("q", "rows", "layout",
                                                 "mirrors"))
    m0 = mirrors[0]
    n_rows = int((rows >= 0).sum())
    row_bytes = m0.dim + 8 if m0.quantized else m0.dim * 4 + 4
    x_sq = max(float(m._sq[:m.next_slot].max()) for m in mirrors
               if m.next_slot)
    tol = (RESCORE_RTOL * (np.einsum("qd,qd->q", q, q) + x_sq)
           + RESCORE_ATOL)
    out = {"queries": int(rows.shape[0]), "window": int(rows.shape[1]),
           "rows": n_rows, "bytes": n_rows * row_bytes,
           "mirror_dtype": m0.dtype}

    def hold(name, d_nat, d_np):
        bad = ~(np.isclose(d_nat, d_np, rtol=0, atol=0)
                | (np.abs(d_nat - d_np) <= tol[:, None]))
        out[f"{name}_max_abs_err"] = float(np.nanmax(np.where(
            np.isfinite(d_np), np.abs(d_nat - d_np), 0.0)))
        if bad.any():
            raise AssertionError(f"{label} {name}: {int(bad.sum())} native "
                                 f"distances off the numpy form's")

    forms = {}
    for form, nat in (("native", True), ("numpy", False)):
        forms[form], out[f"rescore_exact_{form}_s"] = _timed(
            lambda: VectorDBEngine._rescore_exact(
                q, rows, layout, mirrors, top=cap["top"], native=nat))
    (d_nat, r_nat), (d_np, r_np) = forms["native"], forms["numpy"]
    hold("rescore_exact", d_nat[:, :10], d_np[:, :10])
    apart, ties = _tie_mismatches(r_nat, r_np, d_np, tol)
    out["top10_id_mismatches"] = ties
    if apart:
        raise AssertionError(f"{label}: {apart} top-10 ids differ outside "
                             "a near-tie")
    if "adc" in cap:  # the adaptive IVF-PQ path
        full = np.ones(rows.shape, bool)
        masked = {}
        for form, nat in (("native", True), ("numpy", False)):
            masked[form], out[f"exact_masked_{form}_s"] = _timed(
                lambda: VectorDBEngine._exact_masked(
                    q, rows, full, layout, mirrors, native=nat))
        hold("exact_masked", masked["native"], masked["numpy"])
        backend = eng.rescore_backend
        ranked, counts = {}, {}
        try:
            for form in ("native", "numpy"):
                eng.rescore_backend = form
                before = dict(eng.stats)
                ranked[form], out[f"adaptive_{form}_s"] = _timed(
                    lambda: eng._rescore_adaptive(
                        q, rows, cap["adc"], cap["err"], cap["k"], layout,
                        mirrors, top=cap["top"]))
                counts[form] = tuple(
                    (eng.stats[c] - before[c]) // RESCORE_REPS
                    for c in ("rescored_rows", "rescore_skipped_rows"))
        finally:
            eng.rescore_backend = backend
        out["adaptive_rescored_skipped"] = counts["native"]
        if counts["native"] != counts["numpy"]:
            raise AssertionError(f"{label}: adaptive counters differ: "
                                 f"{counts}")
        (da, ra), (dp, rp) = ranked["native"], ranked["numpy"]
        hold("adaptive", da[:, :10], dp[:, :10])
        apart, ties = _tie_mismatches(ra, rp, dp, tol)
        out["adaptive_top10_id_mismatches"] = ties
        if apart:
            raise AssertionError(f"{label}: adaptive top-10 ids differ "
                                 f"outside a near-tie ({apart})")
    for form in ("native", "numpy"):
        out[f"rescore_exact_{form}_GBps"] = (
            out["bytes"] / out[f"rescore_exact_{form}_s"] / 1e9)
    log(f"{label} rescore, b{out['queries']} x {out['window']} candidates "
        f"({n_rows} rows, {out['bytes']} bytes of {m0.dtype} mirror rows): "
        + json.dumps(out))
    return out


# ----------------------------------------------------- int8 storage tier


def _int8_engine(tt, cfg, keys, data, label: str):
    """A fresh engine over the rows: (engine, put_rows + flush seconds)."""
    eng = tt.VectorDBEngine(cfg)
    t0 = time.perf_counter()
    res = eng.put_rows(keys, data)
    assert res.success, res.message
    eng.flush()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    info = eng.info()
    assert info["quantized"] and info["storage_dtype"] == "int8", info
    log(f"{label} build: {len(keys)} rows in {build_s:.3f} s (put_rows + "
        f"flush), rescore_mode {cfg.rescore_mode!r}, device index "
        f"{info['device_bytes']} bytes")
    return eng, build_s


def _rescore_share(stage_p50s: dict) -> float:
    """The host rescore's share of the engine's timed stages (p50s). The
    rescore runs inside search.assemble, so it is not added to the sum."""
    total = sum(v for name, v in stage_p50s.items()
                if name != "search.rescore")
    return stage_p50s.get("search.rescore", 0.0) / total if total else 0.0


def phase_flat_int8(tt) -> dict:
    """The flat int8 engine at 1M x 512 in the three rescore modes. Torch
    ops only (`_int_mm`, top-k, the re-rank): no hand-written kernel."""
    rng = np.random.default_rng(0)       # the engine phase's rows again
    cfg = tt.DBConfig(vector_dim=512, storage_dtype="int8")
    assert (cfg.index_type == "flat" and cfg.rescore_mode == "exact"
            and cfg.rescore_overfetch == 16 and cfg.shard_count == 4)
    data = _unit_rows(rng, ENGINE_ROWS, cfg.vector_dim)
    keys = [f"doc{i}" for i in range(ENGINE_ROWS)]
    queries = _unit_rows(rng, max(ENGINE_BATCHES), cfg.vector_dim)
    truth = _exact_truth(data, queries)

    eng, build_s = _int8_engine(tt, cfg, keys, data, "flat int8 engine")
    idx = eng._index
    f32_bytes = idx.layout.total_rows * (cfg.vector_dim * 4 + 4 + 1)
    out = {"build_s": build_s, "rows": ENGINE_ROWS,
           "device_bytes": idx.nbytes(), "device_bytes_f32": f32_bytes}
    log(f"flat int8 device corpus {tuple(idx.vectors.shape)} "
        f"{idx.vectors.dtype}: {idx.nbytes()} bytes, against {f32_bytes} "
        f"for the same rows in f32")
    _timed_searches(eng, "flat int8 engine", queries, ENGINE_BATCHES, out)
    for b in ENGINE_BATCHES:
        out[f"b{b}"]["rescore_share"] = _rescore_share(
            out[f"b{b}"]["stage_p50_ms"])
    log("flat int8 engine host rescore share of the stage p50s: "
        + ", ".join(f"b{b} {out[f'b{b}']['rescore_share']:.3f}"
                    for b in ENGINE_BATCHES))
    out["b256_device"] = _device_share(eng, queries, "flat int8 engine")
    _, got = eng.search_batch(queries, 10)
    out["recall_at_10"] = _recall(got, truth, keys)
    log(f"flat int8 engine recall@10 (exact rescore vs exact f32 scan, "
        f"{len(queries)} queries): {out['recall_at_10']:.4f}")
    if out["recall_at_10"] < RECALL_MIN:
        raise AssertionError(f"flat int8 recall@10 {out['recall_at_10']} < "
                             f"{RECALL_MIN}")
    out["rescore"] = phase_rescore(eng, queries, "flat int8 engine")
    # a write is visible before and after the flush that quantizes it
    from tpuvdb_torch.core.types import VectorData

    probe = _unit_rows(rng, 1, cfg.vector_dim)
    assert eng.put(VectorData(key="doc5", vector=probe[0].tolist())).success
    assert eng.delete(got[1][0]).success
    for when in ("before flush", "after flush"):
        _, kp = eng.search_batch(probe, 10)
        assert kp[0][0] == "doc5", (when, kp[0][:3])
        _, kv = eng.search_batch(queries[1:2], 10)
        assert got[1][0] not in kv[0], when
        eng.flush()
    eng.close()
    del eng, idx
    torch.cuda.empty_cache()

    for mode in ("device", "none"):
        cfg_m = tt.DBConfig(vector_dim=512, storage_dtype="int8",
                            rescore_mode=mode)
        eng, b_s = _int8_engine(tt, cfg_m, keys, data,
                                f"flat int8 engine ({mode})")
        side = {"build_s": b_s}
        _timed_searches(eng, f"flat int8 engine ({mode})", queries, (256,),
                        side, reps=SIDE_REPS)
        _, got = eng.search_batch(queries, 10)
        side["recall_at_10"] = _recall(got, truth, keys)
        log(f"flat int8 engine ({mode}) recall@10: "
            f"{side['recall_at_10']:.4f}")
        out[mode] = side
        eng.close()
        del eng
        torch.cuda.empty_cache()
    log("flat int8 engine: torch ops only (_int_mm, top-k, re-rank); it "
        "launches no hand-written kernel")
    return out


def phase_ivf_int8(tt, ivf_probe, data, queries, truth, keys):
    """The IVF int8 engine over the ivf engine phase's rows. Returns
    (out, expanded int8 launches of the engine's searches, compact int8
    launches of the b1,024 index search)."""
    cfg = _ivf_config(tt, storage_dtype="int8")
    assert cfg.rescore_mode == "exact" and cfg.rescore_overfetch == 16
    eng, build_s = _int8_engine(tt, cfg, keys, data, "ivf int8 engine")
    st = eng._ivf.stats()
    log(f"ivf int8 engine index: nlist {st.nlist}, cell_pad {st.cell_pad}, "
        f"grouped rows {st.grouped_rows}, spill rows {st.spill_rows}, fill "
        f"{st.fill:.4f}, cells {eng._ivf.grouped.dtype}")
    out = {"build_s": build_s, "rows": len(keys),
           "device_bytes": eng._ivf.nbytes(),
           "stats": dataclasses.asdict(st)}
    ivf_probe.LAUNCHES_EXPANDED_INT8 = ivf_probe.LAUNCHES_COMPACT_INT8 = 0
    _timed_searches(eng, "ivf int8 engine", queries, IVF_BATCHES, out)
    for b in IVF_BATCHES:
        out[f"b{b}"]["rescore_share"] = _rescore_share(
            out[f"b{b}"]["stage_p50_ms"])
    out["b256_device"] = _device_share(eng, queries[:256], "ivf int8 engine")
    _, got = eng.search_batch(queries[:256], 10)
    launches_expanded = ivf_probe.LAUNCHES_EXPANDED_INT8
    out["recall_at_10"] = _recall(got, truth[:256], keys)
    log(f"ivf int8 engine recall@10 (exact rescore, b256 vs exact f32 "
        f"scan): {out['recall_at_10']:.4f}")
    if out["recall_at_10"] < RECALL_MIN:
        raise AssertionError(f"ivf int8 recall@10 {out['recall_at_10']} < "
                             f"{RECALL_MIN}")
    if launches_expanded <= 0:
        raise AssertionError("the IVF int8 engine's search never launched "
                             "the expanded int8 probe kernel")
    out["rescore"] = phase_rescore(eng, queries, "ivf int8 engine")
    ivf_probe.LAUNCHES_COMPACT_INT8 = 0
    out["index_compact"] = phase_ivf_index_compact(eng, queries, truth, keys,
                                                   ivf_probe)
    launches_compact = ivf_probe.LAUNCHES_COMPACT_INT8
    if launches_compact <= 0:
        raise AssertionError("the b1,024 int8 index search never launched "
                             "the compact int8 probe kernel")
    phase_ivf_writes(eng, data, queries)
    eng.close()
    del eng
    torch.cuda.empty_cache()

    eng, b_s = _int8_engine(tt, _ivf_config(tt, storage_dtype="int8",
                                            rescore_mode="none"),
                            keys, data, "ivf int8 engine (none)")
    side = {"build_s": b_s}
    _timed_searches(eng, "ivf int8 engine (none)", queries, (256,), side,
                    reps=SIDE_REPS)
    _, got = eng.search_batch(queries[:256], 10)
    side["recall_at_10"] = _recall(got, truth[:256], keys)
    log(f"ivf int8 engine (none) recall@10: {side['recall_at_10']:.4f}")
    out["none"] = side
    eng.close()
    del eng
    torch.cuda.empty_cache()

    # int8 mirrors: the exact rescore reads 1 byte a dimension (the native
    # int8 loop) and dequantizes in the numpy form
    label = "ivf int8 engine (int8 mirrors)"
    eng, b_s = _int8_engine(tt, _ivf_config(tt, storage_dtype="int8",
                                            mirror_dtype="int8"),
                            keys, data, label)
    side = {"build_s": b_s}
    _timed_searches(eng, label, queries, (256,), side, reps=SIDE_REPS)
    side["b256_device"] = _device_share(eng, queries[:256], label)
    _, got = eng.search_batch(queries[:256], 10)
    # reported, not held: the exact re-rank ranks the stored int8 rows,
    # so the mirrors' own quantization bounds the recall against f32
    side["recall_at_10"] = _recall(got, truth[:256], keys)
    log(f"{label} recall@10 (re-ranked on the int8 rows): "
        f"{side['recall_at_10']:.4f}")
    side["rescore"] = phase_rescore(eng, queries, label)
    out["int8_mirrors"] = side
    eng.close()
    del eng
    torch.cuda.empty_cache()
    # the restart with int8 mirrors too: the cells take the mirrors' codes
    out["restart"] = phase_ivf_restart(tt, "ivf int8 (int8 mirrors)",
                                       storage_dtype="int8",
                                       mirror_dtype="int8")
    return out, launches_expanded, launches_compact


# ------------------------------------------------------------- IVF-PQ


def _sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def _pq_work(plan, lut, mb: int, m2: int, nlist: int) -> dict:
    """Bytes and shared-memory lookups this probe needs: over all tiles the
    union of chunks, each read once at Mb code bytes and a 4-byte bias a
    row, with the LUTs, the coarse product, the three lists and the
    outputs; per tile QT x rows x M2 lookups."""
    lists = plan.cells.long()
    per_tile = ((lists[:, 1:] != lists[:, :-1]).sum(dim=1) + 1)
    tile_rows = int(per_tile.sum()) * 128
    union_rows = int(torch.unique(lists).numel()) * 128
    qp = plan.queries.shape[0]
    nbytes = (union_rows * (mb + 4) + lut.numel() * 2 + qp * nlist * 4
              + 3 * plan.cells.numel() * 4 + qp * 128 * plan.n_segments * 8)
    return {"tile_rows": tile_rows, "union_rows": union_rows,
            "bytes": nbytes, "lookups": float(plan.query_tile) * tile_rows
            * m2, "n_codes": 256 if m2 == mb else 16}


def _pq_bound(work: dict, sm_clocks: float) -> tuple:
    """(ms, "bytes" | "operations"). `sm_clocks` is SMs x clock. 256-code
    tables live in shared memory, which hands out 128 bytes a clock and SM,
    64 bf16 entries; a 16-code table fits in registers, so there only the
    f32 addition each lookup feeds is counted."""
    t_bytes = work["bytes"] / PEAK_BYTES_PER_S * 1e3
    per_clock = (SMEM_BYTES_PER_CLOCK / LUT_ENTRY_BYTES
                 if work["n_codes"] == 256 else F32_LANES_PER_CLOCK)
    t_ops = work["lookups"] / (sm_clocks * per_clock) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _hold_pq(pq_probe, name, args, reps: int, work: dict,
             sm_clocks: float) -> dict:
    """Holds the PQ kernel against its plain twin on one input, bit for
    bit, and times both; raises on any difference."""
    val_k, idx_k = pq_probe.pq_candidates(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    val_p, idx_p = pq_probe.pq_candidates_plain(*args)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    agree = (idx_k == idx_p).float().mean().item()
    err = (val_k - val_p).abs().max().item()
    filled = (idx_k >= 0).float().mean().item()
    log(f"pq kernel check {name}: slots agree {agree:.6f}, max |score diff| "
        f"{err:.3e}, {filled:.4f} of slots filled")
    if not torch.equal(idx_k, idx_p) or not torch.equal(val_k, val_p):
        raise AssertionError(f"{name}: the PQ kernel and its plain twin "
                             "differ (they must agree bit for bit)")
    if filled <= 0:
        raise AssertionError(f"{name}: no candidate at all")
    ms = cuda_ms(lambda: pq_probe.pq_candidates(*args), reps)
    bound, by = _pq_bound(work, sm_clocks)
    row = {"name": name, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": by, "max_abs_err": err, **work}
    log("pq kernel timing " + json.dumps(row))
    return row


def _pq_case(pq_probe, name, nq, codes, n_codes, dsub, nlist, cell_pad, gen,
             sm_clocks) -> dict:
    """One synthetic case: seeded codebooks, centroids, norms and queries
    over the given code table of equal cells."""
    dev = codes.device
    n_g, mb = codes.shape
    m2 = mb if n_codes == 256 else 2 * mb
    d = m2 * dsub
    cb = torch.randn((m2, n_codes, dsub), generator=gen, device=dev) * 0.2
    cents = torch.randn((nlist, d), generator=gen, device=dev)
    sq = torch.rand(n_g, generator=gen, device=dev) * 100.0 + 700.0
    valid = torch.rand(n_g, generator=gen, device=dev) >= 0.01
    offs = torch.arange(nlist, dtype=torch.int32, device=dev) * cell_pad
    q = torch.randn((nq, d), generator=gen, device=dev)
    plan, lut, cellof, bias = pq_probe.pq_probe_inputs(
        q, cents, cb, valid, sq, offs, cell_pad, PQ_FETCH, PQ_NPROBE, n_g)
    assert plan.n_segments == 10 and not plan.compact
    args = (lut, plan.qc2, plan.cells, plan.segs, cellof, codes, bias,
            plan.n_segments, plan.query_tile)
    work = _pq_work(plan, lut, mb, m2, nlist)
    row = _hold_pq(pq_probe, name, args, 20 if nq <= 32 else 5, work,
                   sm_clocks)
    row.update(Q=nq, code_bytes=mb, n_codes=n_codes, d=d)
    return row


def phase_pq_kernel(pq_probe, sm_clocks: float) -> dict:
    """The PQ probe kernel vs its plain twin at the capacity shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    n_g = PQ_NLIST * PQ_CELL
    codes = torch.randint(0, 256, (n_g, PQ_BYTES), generator=gen, device=dev,
                          dtype=torch.uint8)
    log(f"pq kernel table: {n_g} rows x {PQ_BYTES} bytes "
        f"({codes.numel()} bytes of codes), nlist {PQ_NLIST}, cell_pad "
        f"{PQ_CELL}, nprobe {PQ_NPROBE}, fetch {PQ_FETCH}")
    rows = []
    for nq in PQ_QS:
        rows.append(_pq_case(
            pq_probe, f"8-bit Q={nq} Mb={PQ_BYTES} d={PQ_D}", nq, codes, 256,
            PQ_D // PQ_BYTES, PQ_NLIST, PQ_CELL, gen, sm_clocks))
    rows.append(_pq_case(
        pq_probe, f"4-bit Q=32 Mb={PQ_BYTES} d={PQ_D}", 32, codes, 16,
        PQ_D // (2 * PQ_BYTES), PQ_NLIST, PQ_CELL, gen, sm_clocks))
    # 50 bytes a row from a base off 16 bytes: the kernel's byte loads
    n_r = 512 * PQ_CELL
    ragged = codes.view(-1)[1:1 + n_r * 50].view(n_r, 50)
    assert ragged.data_ptr() % 16 != 0
    rows.append(_pq_case(pq_probe, "8-bit ragged Q=8 Mb=50 d=400 (pointer "
                         "off 16 bytes)", 8, ragged, 256, 8, 512, PQ_CELL,
                         gen, sm_clocks))
    del codes, ragged
    torch.cuda.empty_cache()
    main = next(r for r in rows if r["Q"] == 256)
    return {"rows": rows, "main": main,
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


def _pq_engine_kernel_check(pq_probe, eng, queries, sm_clocks) -> dict:
    """The PQ kernel vs its twin on the engine's own index, at the shapes
    its b256 search gives it."""
    q = torch.from_numpy(queries[:256]).cuda()
    return _hold_pq_index(pq_probe, eng._ivf, q, eng._ivf.nprobe,
                          "engine index", 5, sm_clocks)


def _hold_pq_index(pq_probe, ivf, q, nprobe: int, label: str, reps: int,
                   sm_clocks) -> dict:
    """The PQ kernel vs its twin on an IVF-PQ index at fetch PQ_FETCH."""
    plan, lut, cellof, bias = pq_probe.pq_probe_inputs(
        q, ivf.centroids, ivf.pq_codebooks, ivf.grouped_valid,
        ivf.grouped_sq, ivf.cell_offsets, ivf.cell_pad, PQ_FETCH,
        min(nprobe, ivf.nlist), ivf.grouped.shape[0], ivf.pq_rotation)
    args = (lut, plan.qc2, plan.cells, plan.segs, cellof, ivf.grouped, bias,
            plan.n_segments, plan.query_tile)
    mb, d = ivf.grouped.shape[1], ivf.centroids.shape[1]
    work = _pq_work(plan, lut, mb, ivf.pq_codebooks.shape[0], ivf.nlist)
    return _hold_pq(pq_probe, f"{label} Q={q.shape[0]} Mb={mb} d={d}",
                    args, reps, work, sm_clocks)


def _pq_recall(eng, queries, truth, keys, label: str) -> dict:
    """recall@10 of b256 under the exact rescore, at the configured window
    and, if that misses RECALL_MIN, at the first wider one that reaches it
    (named in the log); fails if none does."""
    default = eng.config.ivf_pq_rescore_overfetch
    mesh = type(eng._ivf).__name__ == "ShardedIVFIndex"
    out = {}
    for window in [w for w in PQ_WINDOWS if w >= default]:
        eng.config.ivf_pq_rescore_overfetch = window
        _, got = eng.search_batch(queries[:256], 10)
        recall = _recall(got, truth[:256], keys)
        out[f"recall_at_10_window_{window}"] = recall
        # a mesh engine ranks its whole power-of-two fetch, as the
        # reference's does
        ranked = (1 << (10 * window - 1).bit_length() if mesh
                  else 10 * window)
        log(f"{label} recall@10 (exact rescore of {window} x k candidates, "
            f"{ranked} ranked, b256 vs exact f32 scan): {recall:.4f}")
        if recall >= RECALL_MIN:
            out.update(recall_at_10=recall, window=window)
            break
    eng.config.ivf_pq_rescore_overfetch = default
    if "window" not in out:
        raise AssertionError(f"{label}: recall@10 < {RECALL_MIN} at every "
                             f"window of {PQ_WINDOWS}")
    if out["window"] != default:
        log(f"{label}: the default window {default} x k misses "
            f"{RECALL_MIN} on this corpus; {out['window']} x k reaches it")
    return out


def _pq_full_cell_append(eng, data) -> dict:
    """A delta overflow whose rows crowd one cell: the cell's free slots
    fill and the rest spill, in place, and every row stays searchable."""
    rng = np.random.default_rng(6)
    ivf = eng._ivf
    n_new = eng.config.ivf_delta_max + 16
    crowd = min(3000, n_new // 5)
    fresh = data[20_000:20_000 + n_new] + 0.2 * rng.standard_normal(
        (n_new, IVF_D)).astype(np.float32)
    fresh[:crowd] = data[7] + 0.2 * rng.standard_normal(
        (crowd, IVF_D)).astype(np.float32)
    spill0 = ivf.stats().spill_rows
    assert eng.put_rows([f"c{i}" for i in range(n_new)], fresh).success
    eng.flush()
    assert eng._ivf is ivf, "the crowded append rebuilt the index"
    spilled = ivf.stats().spill_rows - spill0
    assert spilled > 0 and eng.info()["ivf_delta"] == 0, spilled
    _, kk = eng.search_batch(fresh[[5, crowd - 1, crowd + 5]], 10)
    assert [r[0] for r in kk] == ["c5", f"c{crowd - 1}", f"c{crowd + 5}"], kk
    log(f"ivf pq engine append past a full cell: {n_new} rows, {crowd} of "
        f"them around one point, {spilled} spilled, all in place: ok")
    return {"rows": n_new, "spilled": spilled}


def _pq_engine(tt, keys, data, label: str, **kw):
    cfg = _ivf_config(tt, ivf_pq_subq=PQ_ENGINE_BYTES, **kw)
    assert (cfg.ivf_pq_rescore_overfetch == 64 and cfg.ivf_checkpoint_packed
            and cfg.ivf_pq_adaptive_rescore and cfg.rescore_mode == "exact")
    eng = tt.VectorDBEngine(cfg)
    t0 = time.perf_counter()
    assert eng.put_rows(keys, data).success
    eng.flush()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ivf = eng._ivf
    st = ivf.stats()
    assert ivf.pq and ivf.grouped.dtype == torch.uint8
    log(f"{label} build: {len(keys)} rows in {build_s:.3f} s (put_rows + "
        f"flush: k-means, codebooks, assignment + encode, bisection, "
        f"packing); nlist {st.nlist}, cell_pad {st.cell_pad}, grouped rows "
        f"{st.grouped_rows}, spill rows {st.spill_rows}, fill {st.fill:.4f},"
        f" codebooks {tuple(ivf.pq_codebooks.shape)}, pq_err "
        f"{ivf.pq_err:.4f}, device index {ivf.nbytes()} bytes")
    return eng, {"build_s": build_s, "rows": len(keys),
                 "device_bytes": ivf.nbytes(), "pq_err": ivf.pq_err,
                 "stats": dataclasses.asdict(st)}


def phase_ivf_pq(tt, pq_probe, data, queries, truth, keys, sm_clocks,
                 other_bytes: dict):
    """The IVF-PQ engine over the ivf engine phase's rows. Returns (out,
    PQ launches of the engine's searches)."""
    eng, out = _pq_engine(tt, keys, data, "ivf pq engine")
    out["device_bytes_f32"] = other_bytes["float32"]
    out["device_bytes_int8"] = other_bytes["int8"]
    log(f"ivf index on the device: {out['device_bytes']} bytes with "
        f"{PQ_ENGINE_BYTES}-byte PQ cells, {other_bytes['int8']} with int8 "
        f"cells, {other_bytes['float32']} with f32 cells")
    pq_probe.LAUNCHES_PQ = 0
    _timed_searches(eng, "ivf pq engine", queries, IVF_BATCHES, out,
                    reps=PQ_REPS)
    for b in IVF_BATCHES:
        out[f"b{b}"]["rescore_share"] = _rescore_share(
            out[f"b{b}"]["stage_p50_ms"])
    out["rescored_rows"] = eng.stats["rescored_rows"]
    out["rescore_skipped_rows"] = eng.stats["rescore_skipped_rows"]
    log(f"ivf pq engine adaptive rescore over the timed searches: "
        f"{out['rescored_rows']} rows re-ranked, "
        f"{out['rescore_skipped_rows']} skipped by the error bound")
    out["b256_device"] = _device_share(eng, queries[:256], "ivf pq engine")
    out.update(_pq_recall(eng, queries, truth, keys, "ivf pq engine"))
    launches = pq_probe.LAUNCHES_PQ
    out["rescore"] = phase_rescore(eng, queries, "ivf pq engine")
    if launches <= 0:
        raise AssertionError("the IVF-PQ engine's search never launched "
                             "the PQ probe kernel")
    out["kernel_engine_shape"] = _pq_engine_kernel_check(
        pq_probe, eng, queries, sm_clocks)
    phase_ivf_writes(eng, data, queries)
    out["full_cell_append"] = _pq_full_cell_append(eng, data)
    eng.close()
    del eng
    torch.cuda.empty_cache()
    out["restart"] = phase_ivf_restart(
        tt, "ivf pq (packed file)", packed=True,
        ivf_pq_subq=PQ_ENGINE_BYTES)

    for name, kw in (("4-bit", {"ivf_pq_bits": 4}), ("opq", {"ivf_opq": True})):
        label = f"ivf pq engine ({name})"
        eng, side = _pq_engine(tt, keys, data, label, **kw)
        _timed_searches(eng, label, queries, (256,), side,
                        reps=PQ_SIDE_REPS)
        side.update(_pq_recall(eng, queries, truth, keys, label))
        out[name] = side
        eng.close()
        del eng
        torch.cuda.empty_cache()
    return out, launches


# ----------------------------------------------------------------- the mesh


def _mesh(shape=None):
    """MESH_SLOTS slots of the one card: a 1-D mesh, or a 2-D (repl,
    shards) one of that shape."""
    from tpuvdb_torch.mesh import create_mesh
    from tpuvdb_torch.mesh.replicated import create_mesh_2d

    devs = ["cuda:0"] * MESH_SLOTS
    if shape is None:
        return create_mesh(devices=devs)
    return create_mesh_2d(*shape, devices=devs)


def _flat_engine(tt, data, keys, label: str, mesh=None, **kw):
    """A flat DBConfig(vector_dim=512) engine over the rows: (engine,
    put_rows + flush seconds)."""
    eng = tt.VectorDBEngine(tt.DBConfig(vector_dim=data.shape[1], **kw),
                            mesh=mesh)
    check_native(eng, label)
    t0 = time.perf_counter()
    assert eng.put_rows(keys, data).success
    eng.flush()
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def _same_keys(label: str, got, want, queries) -> dict:
    """The mesh's (dists, keys) against the single-device engine's: ids
    equal outside near-ties (the scan tolerance of the serve phase),
    distances within it."""
    got_k = np.array([row[:10] for row in got[1]], dtype=object)
    want_k = np.array([row[:10] for row in want[1]], dtype=object)
    want_d = np.asarray(want[0], np.float64)[:, :10]
    tol = RESCORE_RTOL * ((queries * queries).sum(1) + 1.0) + RESCORE_ATOL
    apart, alld = _tie_mismatches(got_k, want_k, want_d, tol)
    same = got_k == want_k
    derr = float(np.abs(np.asarray(got[0], np.float64)[:, :10]
                        - want_d)[same].max())
    res = {"queries": len(queries), "key_mismatches_apart_from_ties": apart,
           "key_mismatches": alld, "max_score_err": derr}
    if apart or derr > float(tol.max()):
        raise AssertionError(f"{label}: keys differ from the single-device "
                             f"engine's: {res}")
    return res


def phase_mesh_flat(tt, scan, work: str) -> tuple:
    """The flat engine on the mesh over the engine phase's 1,000,000 rows:
    "exact" keys on 4 slots and on a 2x2 mesh against the single-device
    engine's, then the default ("approx") engine on 4 slots: latency,
    recall, the scan's launches. The rows, queries and the 2x2 mesh's
    answers go to `work` for the processes' sub-phase. Returns (out, scan
    launches)."""
    rng = np.random.default_rng(0)   # the engine phase's rows and queries
    data = _unit_rows(rng, ENGINE_ROWS, SCAN_D)
    keys = [f"doc{i}" for i in range(ENGINE_ROWS)]
    queries = _unit_rows(rng, max(ENGINE_BATCHES), SCAN_D)
    np.save(os.path.join(work, "flat_rows.npy"), data)
    np.save(os.path.join(work, "flat_queries.npy"), queries)
    in_process = {}
    odd = MESH_ODD_BATCH
    ref, ref_s = _flat_engine(tt, data, keys, "single-device exact engine",
                              search_mode="exact")
    want = {b: ref.search_batch(queries[:b], 10)
            for b in ENGINE_BATCHES + (odd,)}
    out = {"rows": ENGINE_ROWS, "single_device_exact_build_s": ref_s,
           "single_device_bytes": ref.info()["device_bytes"]}
    ref.close()
    del ref
    torch.cuda.empty_cache()
    for label, shape, batches in (
            ("sharded", None, ENGINE_BATCHES),
            ("replicated 2x2", (2, 2), (max(ENGINE_BATCHES), odd))):
        eng, build_s = _flat_engine(tt, data, keys, f"mesh {label}",
                                    mesh=_mesh(shape), search_mode="exact")
        res = {"build_s": build_s, "device_bytes": eng.info()["device_bytes"]}
        for b in batches:
            got = eng.search_batch(queries[:b], 10)
            res[f"keys_b{b}"] = _same_keys(f"mesh {label} b{b}", got,
                                           want[b], queries[:b])
            if shape is not None:
                in_process[f"b{b}"] = [np.asarray(got[0]).tolist(), got[1]]
        if shape is not None:
            _timed_searches(eng, f"mesh {label} exact", queries, (256,), res,
                            reps=MESH_REPS)
        log(f"mesh flat {label} exact: {json.dumps(res)}")
        out[f"{label.split()[0]}_exact"] = res
        eng.close()
        del eng
        torch.cuda.empty_cache()

    scan.LAUNCHES = 0
    eng, build_s = _flat_engine(tt, data, keys, "mesh flat", mesh=_mesh())
    res = {"build_s": build_s, "device_bytes": eng.info()["device_bytes"]}
    _timed_searches(eng, "mesh flat", queries, ENGINE_BATCHES, res)
    res["b256_device"] = _device_share(eng, queries, "mesh flat")
    dist, got = eng.search_batch(queries, 10)
    in_process["approx b256"] = [np.asarray(dist).tolist(), got]
    hit = sum(len(set(g[:10]) & set(w[:10]))
              for g, w in zip(got, want[max(ENGINE_BATCHES)][1]))
    res["recall_at_10"] = hit / (10 * len(queries))
    launches = scan.LAUNCHES
    log(f"mesh flat (approx, {MESH_SLOTS} slots) recall@10 vs the exact "
        f"engine: {res['recall_at_10']:.4f}; scan launches {launches}")
    if res["recall_at_10"] < RECALL_MIN:
        raise AssertionError(f"mesh flat recall@10 {res['recall_at_10']}")
    if launches <= 0:
        raise AssertionError("the mesh's flat search never launched the "
                             "scan kernel")
    out["sharded_approx"] = res
    eng.close()
    del eng, data
    torch.cuda.empty_cache()
    with open(os.path.join(work, "flat_2x2.json"), "w") as f:
        json.dump(in_process, f)
    return out, launches


def _mesh_ivf_engine(tt, data, queries, truth, keys, label: str, **kw):
    """An IVF engine of the ivf engine phase's configuration on the
    4-slot mesh: build, timed b1 / b256, recall@10 >= 0.95 (IVF-PQ under
    the exact rescore). Returns (engine, out, its b256 answer)."""
    eng = tt.VectorDBEngine(_ivf_config(tt, **kw), mesh=_mesh())
    check_native(eng, label)
    t0 = time.perf_counter()
    assert eng.put_rows(keys, data).success
    eng.flush()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ivf = eng._ivf
    st = ivf.stats()
    assert type(ivf).__name__ == "ShardedIVFIndex", type(ivf)
    out = {"build_s": build_s, "rows": len(keys),
           "nlist_per_shard": int(ivf.centroids.shape[1]),
           "device_bytes": ivf.nbytes(), "stats": dataclasses.asdict(st)}
    log(f"{label} build: {len(keys)} rows on {MESH_SLOTS} slots in "
        f"{build_s:.3f} s (per-shard k-means, assignment, bisection, "
        f"packing, upload); {json.dumps(out['stats'])}")
    _timed_searches(eng, label, queries, (1, 256), out, reps=MESH_REPS)
    if kw.get("ivf_pq_subq"):
        out.update(_pq_recall(eng, queries, truth, keys, label))
        # the rest of the phase serves at the window that reaches the
        # recall (the mesh's codebooks train on pre-bisection residuals,
        # as the reference's do, and calibrate no adaptive bound)
        eng.config.ivf_pq_rescore_overfetch = out["window"]
    else:
        _, got = eng.search_batch(queries[:256], 10)
        out["recall_at_10"] = _recall(got, truth[:256], keys)
        log(f"{label} recall@10 (b256 vs exact): {out['recall_at_10']:.4f}")
        if out["recall_at_10"] < RECALL_MIN:
            raise AssertionError(f"{label} recall@10 {out['recall_at_10']}")
    dist, got = eng.search_batch(queries[:256], 10)
    return eng, out, [np.asarray(dist).tolist(), got]


def phase_mesh_ivf(tt, ivf_probe, pq_probe, data, queries, truth,
                   keys, work: str) -> tuple:
    """IVF f32, int8 and IVF-PQ (64 bytes) engines on the 4-slot mesh over
    the first MESH_IVF_ROWS of the ivf engine phase's rows, and a warm
    restart of the f32 one. The rows, queries, truth and the engines' b256
    answers go to `work` for the processes' sub-phase. Returns (out,
    launches by kernel)."""
    if MESH_IVF_ROWS < len(keys):
        data, keys = data[:MESH_IVF_ROWS], keys[:MESH_IVF_ROWS]
        truth = _exact_truth(data, queries)
    np.save(os.path.join(work, "ivf_rows.npy"), data)
    np.save(os.path.join(work, "ivf_queries.npy"), queries[:256])
    np.save(os.path.join(work, "ivf_truth.npy"), truth[:256])
    out, launches, in_process = {}, {}, {}
    for label, kw, counter in (
            ("mesh ivf", {}, "LAUNCHES_EXPANDED"),
            ("mesh ivf int8", {"storage_dtype": "int8"},
             "LAUNCHES_EXPANDED_INT8"),
            ("mesh ivf pq", {"ivf_pq_subq": PQ_ENGINE_BYTES}, "LAUNCHES_PQ")):
        mod = pq_probe if counter == "LAUNCHES_PQ" else ivf_probe
        setattr(mod, counter, 0)
        eng, res, in_process[label] = _mesh_ivf_engine(
            tt, data, queries, truth, keys, label, **kw)
        in_process[label].append(res.get("window"))
        launches[label] = getattr(mod, counter)
        if launches[label] <= 0:
            raise AssertionError(f"{label}: no launch of the probe kernel "
                                 f"({counter})")
        phase_ivf_writes(eng, data, queries, label)
        out[label.replace("mesh ", "").replace(" ", "_")] = res
        eng.close()
        del eng
        torch.cuda.empty_cache()
    out["ivf"]["restart"] = phase_ivf_restart(tt, "mesh ivf", mesh=_mesh())
    log(f"mesh ivf probe launches: {json.dumps(launches)}")
    with open(os.path.join(work, "ivf_in_process.json"), "w") as f:
        json.dump(in_process, f)
    return out, launches


def phase_mesh_nccl(tt) -> dict:
    """initialize_multihost on NCCL at world size 1, a sharded_search over
    the process mesh made after it equal to the in-process mesh's, then
    shutdown_multihost."""
    import torch.distributed as dist

    from tpuvdb_torch.cluster.bootstrap import (initialize_multihost,
                                                shutdown_multihost)
    from tpuvdb_torch.mesh import create_mesh, sharded_search
    from tpuvdb_torch.mesh.sharded import shard_rows

    rng = np.random.default_rng(11)
    corpus = _unit_rows(rng, NCCL_ROWS, SCAN_D)
    q = _unit_rows(rng, 64, SCAN_D)
    sq = (corpus * corpus).sum(1)
    valid = np.ones(len(corpus), bool)
    local = _mesh()
    want = sharded_search(q, *(shard_rows(local, a)
                               for a in (corpus, sq, valid)),
                          k=10, block_size=8192, mesh=local)
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    info = initialize_multihost(coordinator_address=f"127.0.0.1:"
                                f"{_free_port()}", num_processes=1,
                                process_id=0)
    try:
        init_s = time.perf_counter() - t0
        backend = dist.get_backend()
        mesh = create_mesh(devices=["cuda:0"] * MESH_SLOTS)
        assert backend == "nccl" and mesh.distributed, (backend, mesh)
        got = sharded_search(q, *(shard_rows(mesh, a)
                                  for a in (corpus, sq, valid)),
                             k=10, block_size=8192, mesh=mesh)
        same = (torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]))
    finally:
        shutdown_multihost()
    res = {"backend": backend, "topology": info, "init_s": init_s,
           "rows": NCCL_ROWS, "equal_to_in_process": same}
    log(f"mesh across processes: {json.dumps(res)}")
    if not same:
        raise AssertionError("the NCCL process mesh's search differs from "
                             "the in-process mesh's")
    return res


_MESH_WORKER_SRC = r'''
import json, os, sys, time
t_start = time.perf_counter()
rank, port, work, root = int(sys.argv[1]), sys.argv[2], sys.argv[3], \
    sys.argv[4]
sys.path.insert(0, root)
import numpy as np
import torch
import torch.distributed as dist

torch.cuda.set_device(0)
# NCCL takes one rank a card: two ranks on one card join gloo, and
# initialize_multihost then finds the group up and joins nothing
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
import chip_smoke as cs
import tpuvdb_torch as tt
from tpuvdb_torch.cluster.bootstrap import (initialize_multihost,
                                            shutdown_multihost)
from tpuvdb_torch.kernels import ivf_probe, pq_probe, scan
from tpuvdb_torch.mesh import create_mesh
from tpuvdb_torch.mesh.replicated import create_mesh_2d

out = {"rank": rank, "topology": initialize_multihost(),
       "backend": dist.get_backend()}
x = torch.full((2,), float(rank), device="cuda:0")
try:
    parts = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(parts, x)
    out["gloo_all_gather_cuda"] = [float(p[0]) for p in parts] == [0.0, 1.0]
except RuntimeError as e:
    out["gloo_all_gather_cuda"] = f"raises: {str(e)[:160]}"
slots = ["cuda:0", "cuda:0"]   # two slots of the card a process

rows = np.load(os.path.join(work, "flat_rows.npy"), mmap_mode="r")
queries = np.load(os.path.join(work, "flat_queries.npy"))
keys = [f"doc{i}" for i in range(len(rows))]
scan.LAUNCHES = 0
t0 = time.perf_counter()
eng, build_s = cs._flat_engine(tt, rows, keys, "process mesh 2x2",
                               mesh=create_mesh_2d(2, 2, devices=slots),
                               search_mode="exact")
out["flat"] = {"build_s": build_s,
               "device_bytes": eng.info()["device_bytes"]}
for b in (256, cs.MESH_ODD_BATCH):
    d, k = eng.search_batch(queries[:b], 10)
    out["flat"][f"b{b}"] = [np.asarray(d).tolist(), k]
eng.close()
del eng
torch.cuda.empty_cache()
# the default ("approx") engine on the 1-D 4-slot process mesh: the scan
eng, out["flat"]["approx_build_s"] = cs._flat_engine(
    tt, rows, keys, "process mesh approx", mesh=create_mesh(devices=slots))
d, k = eng.search_batch(queries, 10)
out["flat"]["approx b256"] = [np.asarray(d).tolist(), k]
out["flat"]["s"] = time.perf_counter() - t0
out["flat"]["scan_launches"] = scan.LAUNCHES
eng.close()
del eng, rows
torch.cuda.empty_cache()

rows = np.load(os.path.join(work, "ivf_rows.npy"), mmap_mode="r")
queries = np.load(os.path.join(work, "ivf_queries.npy"))
keys = [f"r{i}" for i in range(len(rows))]
with open(os.path.join(work, "ivf_in_process.json")) as f:
    windows = {label: v[2] for label, v in json.load(f).items()}
for label, kw, mod, counter in (
        ("mesh ivf", {}, ivf_probe, "LAUNCHES_EXPANDED"),
        ("mesh ivf pq", {"ivf_pq_subq": cs.PQ_ENGINE_BYTES}, pq_probe,
         "LAUNCHES_PQ")):
    setattr(mod, counter, 0)
    t0 = time.perf_counter()
    eng = tt.VectorDBEngine(cs._ivf_config(tt, **kw),
                            mesh=create_mesh(devices=slots))
    cs.check_native(eng, f"process {label}")
    assert eng.put_rows(keys, rows).success
    eng.flush()
    torch.cuda.synchronize()
    res = {"build_s": time.perf_counter() - t0,
           "stats": eng.info()["ivf"],
           "host_digest": eng._ivf.host_digest()}
    if windows[label]:
        eng.config.ivf_pq_rescore_overfetch = windows[label]
    d, k = eng.search_batch(queries, 10)
    res["b256"] = [np.asarray(d).tolist(), k]
    res["launches"] = getattr(mod, counter)
    res["s"] = time.perf_counter() - t0
    out[label] = res
    eng.close()
    del eng
    torch.cuda.empty_cache()
shutdown_multihost()
out["worker_s"] = time.perf_counter() - t_start
print(json.dumps(out), flush=True)
'''


def phase_mesh_processes(work: str) -> dict:
    """The mesh across processes: two spawned workers, two `cuda:0` slots
    each, in one gloo group (`_MESH_WORKER_SRC`), make the same calls on
    the rows the in-process mesh phases left in `work`. Both workers'
    answers must be equal, and equal to the in-process mesh's outside
    near-ties; recall@10 >= 0.95; the kernels launched in each worker."""
    t0 = time.perf_counter()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MESH_WORKER_SRC, str(rank), str(port), work,
         ROOT], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"mesh worker {rank} failed "
                                 f"(rc {p.returncode}):\n{stderr[-6000:]}")
    workers = [json.loads(stdout.strip().splitlines()[-1])
               for stdout, _ in outs]
    with open(os.path.join(work, "flat_2x2.json")) as f:
        flat_ref = json.load(f)
    with open(os.path.join(work, "ivf_in_process.json")) as f:
        ivf_ref = json.load(f)
    flat_q = np.load(os.path.join(work, "flat_queries.npy"))
    ivf_q = np.load(os.path.join(work, "ivf_queries.npy"))
    truth = np.load(os.path.join(work, "ivf_truth.npy"))
    n_ivf = len(np.load(os.path.join(work, "ivf_rows.npy"), mmap_mode="r"))
    ivf_keys = [f"r{i}" for i in range(n_ivf)]
    res = {"workers": [{"rank": w["rank"], "worker_s": w["worker_s"],
                        "topology": w["topology"], "backend": w["backend"],
                        "gloo_all_gather_cuda": w["gloo_all_gather_cuda"]}
                       for w in workers]}
    a, b = workers
    for part, batches in (("flat", (256, MESH_ODD_BATCH, "approx 256")),
                          ("mesh ivf", (256,)), ("mesh ivf pq", (256,))):
        for bq in batches:
            key = f"b{bq}" if bq != "approx 256" else "approx b256"
            if a[part][key] != b[part][key]:
                raise AssertionError(f"processes {part} {key}: the two "
                                     "workers' answers differ")
            got = a[part][key]
            if part == "flat":
                want = flat_ref[key]
                q = flat_q[:len(got[1])]
            else:
                want = ivf_ref[part][:2]
                q = ivf_q
            res[f"{part} {key}"] = _same_keys(
                f"processes {part} {key}", got, want, q)
            res[f"{part} {key}"]["rows_and_distances_equal"] = got == want
    for part in ("mesh ivf", "mesh ivf pq"):
        recall = _recall(a[part]["b256"][1], truth, ivf_keys)
        res[f"{part} recall_at_10"] = recall
        if recall < RECALL_MIN:
            raise AssertionError(f"processes {part} recall@10 {recall}")
        if a[part]["host_digest"] != b[part]["host_digest"]:
            raise AssertionError(f"processes {part}: host tables differ")
    launches = {"scan_candidates": [w["flat"]["scan_launches"]
                                    for w in workers],
                "ivf_candidates": [w["mesh ivf"]["launches"]
                                   for w in workers],
                "pq_candidates": [w["mesh ivf pq"]["launches"]
                                  for w in workers]}
    for name, per in launches.items():
        if min(per) <= 0:
            raise AssertionError(f"processes: a worker never launched "
                                 f"{name}: {per}")
    res["launches_by_worker"] = launches
    res["launches"] = {name: sum(per) for name, per in launches.items()}
    for w in workers:
        res[f"rank{w['rank']}_s"] = {
            part: {k: w[part][k] for k in ("build_s", "approx_build_s", "s")
                   if k in w[part]}
            for part in ("flat", "mesh ivf", "mesh ivf pq")}
    res["device_bytes_2x2"] = a["flat"]["device_bytes"]
    res["ivf_stats"] = {p: a[p]["stats"] for p in ("mesh ivf",
                                                   "mesh ivf pq")}
    res["phase_s"] = time.perf_counter() - t0
    log(f"mesh across processes (2 gloo workers x 2 slots of cuda:0): "
        f"{json.dumps(res)}")
    log(f"mesh across processes: sub-phase {res['phase_s']:.1f} s; worker "
        f"seconds {[w['worker_s'] for w in workers]}")
    return res


def phase_mesh(tt, scan, ivf_probe, pq_probe, ivf_data) -> tuple:
    """Every mesh path on MESH_SLOTS slots of the card. Returns (out,
    launches by kernel name)."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="mesh_processes_")
    try:
        flat, scan_launches = phase_mesh_flat(tt, scan, work)
        ivf, probe_launches = phase_mesh_ivf(tt, ivf_probe, pq_probe,
                                             *ivf_data, work)
        procs = phase_mesh_processes(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    from tpuvdb_torch.mesh.dryrun import dryrun_multichip

    out = {"slots": ["cuda:0"] * MESH_SLOTS, "flat": flat, "ivf": ivf,
           "nccl": phase_mesh_nccl(tt), "processes": procs,
           "dryrun": dryrun_multichip(MESH_SLOTS,
                                      devices=["cuda:0"] * MESH_SLOTS)}
    log(f"mesh dry run ({MESH_SLOTS} slots): {json.dumps(out['dryrun'])}")
    out["phase_s"] = time.perf_counter() - t0
    # the workers' launches join the in-process mesh's
    by = procs["launches"]
    return out, {"scan_candidates": scan_launches + by["scan_candidates"],
                 "ivf_candidates": probe_launches["mesh ivf"]
                 + by["ivf_candidates"],
                 "ivf_candidates_int8": probe_launches["mesh ivf int8"],
                 "pq_candidates": probe_launches["mesh ivf pq"]
                 + by["pq_candidates"]}


# ------------------------------------------------------------------ main


def log_sass_counts(libs) -> None:
    """Each library's tensor-core (HGMMA: bf16 / tf32; IGMMA: s8) and TMA
    load (UTMALDG) instructions, from cuobjdump -sass where it is
    installed."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        log("cuobjdump not found: no SASS instruction counts")
        return
    for lib in libs:
        sass = subprocess.run([tool, "-sass", lib.library],
                              capture_output=True, text=True,
                              check=True).stdout
        counts = {op: sass.count(op) for op in ("HGMMA", "IGMMA", "UTMALDG")}
        log(f"sass {os.path.basename(lib.library)}: {json.dumps(counts)}")



def log_stage_table(results: dict) -> None:
    """b1 and b256 of each engine: the stage p50s search.device,
    search.assemble and (inside it) search.rescore, the p50, and the
    device's idle share under torch.profiler (b256)."""
    log("engine | batch | search.device | search.assemble | search.rescore "
        "| p50 ms | idle share")
    for name, out in results.items():
        for b in ("b1", "b256"):
            if b not in out:
                continue
            st = out[b]["stage_p50_ms"]
            idle = (out.get("b256_device", {}).get("device_idle_share",
                                                   "not measured")
                    if b == "b256" else "not measured")
            cells = [st.get(k, "-") for k in ("search.device",
                                              "search.assemble",
                                              "search.rescore")]
            log(f"{name} | {b} | " + " | ".join(
                f"{c:.3f}" if isinstance(c, float) else str(c)
                for c in cells + [out[b]["p50_ms"], idle]))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import tpuvdb_torch as tt
    from tpuvdb_torch.kernels import ivf_probe, pq_probe, scan

    wall0 = time.perf_counter()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    libs = (scan.LIBRARY, ivf_probe.LIBRARY, pq_probe.LIBRARY)
    # one nvcc per source, all started together, beside the g++ build of
    # the native host runtime
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        host = pool.submit(build_native)
        list(pool.map(lambda lib: lib.load(), libs))
        native_build = host.result()
    log(f"kernels built in {time.perf_counter() - wall0:.1f} s")
    log(f"native host runtime (tpuvdb_torch/native, g++ -O3): compiled "
        f"{json.dumps(native_build['build_s'])} s, loaded in "
        f"{native_build['load_s']:.2f} s; g++ -fopt-info-vec on the rescore "
        f"dot loops (lines {native_build['dot_loop_lines']}): "
        + " | ".join(native_build["vectorizer"]))
    for lib in libs:
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"nvcc {os.path.basename(lib.source)}: {line.strip()}")
    log_sass_counts(libs)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = _sm_clock_hz()
    sm_clocks = sm_count * clock_hz
    log(f"lookup rates: {sm_count} SMs x {clock_hz / 1e6:.0f} MHz (nvidia-smi "
        f"clocks.max.sm) x {SMEM_BYTES_PER_CLOCK} shared-memory bytes a "
        f"clock / {LUT_ENTRY_BYTES} bytes an entry = "
        f"{sm_clocks * SMEM_BYTES_PER_CLOCK / LUT_ENTRY_BYTES:.4e} entries/s "
        f"(256 codes); x {F32_LANES_PER_CLOCK} f32 additions a clock = "
        f"{sm_clocks * F32_LANES_PER_CLOCK:.4e} /s (16 codes)")

    kern = phase_kernel(scan)
    scan.LAUNCHES = 0
    eng = phase_engine(tt, scan)
    launches = scan.LAUNCHES
    log("engine " + json.dumps(eng))
    if launches <= 0:
        raise AssertionError("the engine's search never launched the "
                             "scan kernel")
    durable = {backend: phase_durability(tt, backend)
               for backend in ("ram", "mmap")}
    t0 = time.perf_counter()
    scan.LAUNCHES = 0
    served = phase_serve(tt, scan, eng)
    launches_serve = scan.LAUNCHES
    served["phase_s"] = time.perf_counter() - t0
    log("serve " + json.dumps(served))
    if launches_serve <= 0:
        raise AssertionError("the served searches never launched the scan "
                             "kernel")
    t0 = time.perf_counter()
    federated = phase_federation(tt)
    federated["phase_s"] = time.perf_counter() - t0
    log("federation " + json.dumps(federated))
    t0 = time.perf_counter()
    clipped = phase_clip(tt, scan)
    launches_clip = clipped["scan_launches"]
    clipped["e2e"] = phase_clip_e2e()
    clipped["phase_s"] = time.perf_counter() - t0
    log("clip " + json.dumps(clipped))
    benched = phase_bench(scan, ivf_probe)
    launches_bench = benched["scan"]["launches"]
    log(f"bench phase {benched['phase_s']:.1f} s")

    ivf_kern = phase_ivf_kernel(ivf_probe)
    ivf_probe.LAUNCHES_EXPANDED = ivf_probe.LAUNCHES_COMPACT = 0
    ivf_eng, data, queries, truth, keys, ivf_out = phase_ivf_engine(tt)
    launches_expanded = ivf_probe.LAUNCHES_EXPANDED
    if launches_expanded <= 0:
        raise AssertionError("the IVF engine's search never launched the "
                             "expanded probe kernel")
    ivf_probe.LAUNCHES_COMPACT = 0
    ivf_out["index_compact"] = phase_ivf_index_compact(
        ivf_eng, queries, truth, keys, ivf_probe)
    launches_compact = ivf_probe.LAUNCHES_COMPACT
    if launches_compact <= 0:
        raise AssertionError("the b1,024 index search never launched the "
                             "compact probe kernel")
    phase_ivf_writes(ivf_eng, data, queries)
    ivf_eng.close()
    del ivf_eng
    torch.cuda.empty_cache()
    ivf_out["restart"] = phase_ivf_restart(tt)
    log("ivf engine " + json.dumps(ivf_out))

    flat8 = phase_flat_int8(tt)
    log("flat int8 engine " + json.dumps(flat8))
    ivf8, launches_expanded_i8, launches_compact_i8 = phase_ivf_int8(
        tt, ivf_probe, data, queries, truth, keys)
    log("ivf int8 engine " + json.dumps(ivf8))

    pq_kern = phase_pq_kernel(pq_probe, sm_clocks)
    pq_out, launches_pq = phase_ivf_pq(
        tt, pq_probe, data, queries, truth, keys, sm_clocks,
        {"float32": ivf_out["device_bytes"], "int8": ivf8["device_bytes"]})
    log("ivf pq engine " + json.dumps(pq_out))
    mesh_out, mesh_launches = phase_mesh(tt, scan, ivf_probe, pq_probe,
                                         (data, queries, truth, keys))
    log("mesh " + json.dumps(mesh_out))
    log(f"mesh phase {mesh_out['phase_s']:.1f} s")
    del data
    # last: capacity_engine and capacity_pq set keep_malloc_warm (a
    # process-wide mallopt, as the reference's scripts do), which would
    # change the host times of any phase after them
    keep = tempfile.mkdtemp(prefix="chip_smoke_keep_", dir=ROOT)
    try:
        cap = phase_capacity(scan, ivf_probe, pq_probe, sm_clocks, keep)
        ops = phase_ops(scan, ivf_probe, pq_probe, keep)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    launches_ops = {"scan_candidates": ops["serving_ab"]["launches"],
                    "ivf_candidates_int8": ops["ivf_b1"]["launches"][
                        "expanded"],
                    "pq_candidates": ops["pq_recall"]["launches"]}
    launches_latency = {
        name: sum(run["launches"][name] for run in cap["latency"].values())
        for name in ("scan_candidates", "ivf_candidates")}
    log(f"launches: scan {launches} (flat engine phase), "
        f"{launches_serve} (serve phase, HTTP) and {launches_clip} (clip "
        f"phase, one client's /api/search), "
        f"{launches_bench['scan_candidates']} (bench phase, bench --suite "
        f"scan), {launches_latency['scan_candidates']} (capacity phase, "
        f"bench/latency.py), ivf expanded {launches_expanded} (ivf engine "
        f"phase), {launches_bench['ivf_candidates']} (bench phase) and "
        f"{launches_latency['ivf_candidates']} (capacity phase, latency), "
        f"ops phase {json.dumps(launches_ops)} (serving_ab, diag_ivf_b1's "
        f"int8 probe, diag_pq_recall; the cluster's nodes count theirs in "
        f"their own processes: their search.device timers are read), "
        f"ivf compact "
        f"{launches_compact} (b1,024 index search), ivf expanded int8 "
        f"{launches_expanded_i8} (ivf int8 engine's searches) and "
        f"{cap['capacity_ivf']['launches']} (capacity phase, "
        f"capacity_ivf), ivf compact "
        f"int8 {launches_compact_i8} (b1,024 int8 index search), pq "
        f"{launches_pq} (ivf pq engine's searches) and "
        f"{cap['capacity_pq']['launches']} (capacity phase, capacity_pq); "
        f"on the mesh "
        f"{json.dumps(mesh_launches)}; the flat int8 engine launches no "
        f"hand-written kernel")
    log_stage_table({
        "flat f32": eng, "ivf f32": ivf_out, "flat int8": flat8,
        "ivf int8": ivf8, "ivf int8 (int8 mirrors)": ivf8["int8_mirrors"],
        "ivf pq": pq_out, "mesh flat f32": mesh_out["flat"]["sharded_approx"],
        "mesh flat f32 2x2 exact": mesh_out["flat"]["replicated_exact"],
        "mesh ivf f32": mesh_out["ivf"]["ivf"],
        "mesh ivf int8": mesh_out["ivf"]["ivf_int8"],
        "mesh ivf pq": mesh_out["ivf"]["ivf_pq"]})
    log("host rescore, native against numpy (b256 candidates of a real "
        "search): " + json.dumps({
            name: {k: r[k] for k in ("rows", "bytes", "mirror_dtype",
                                     "rescore_exact_native_s",
                                     "rescore_exact_numpy_s",
                                     "top10_id_mismatches")}
            for name, r in (("flat int8", flat8["rescore"]),
                            ("ivf int8", ivf8["rescore"]),
                            ("ivf int8 (int8 mirrors)",
                             ivf8["int8_mirrors"]["rescore"]),
                            ("ivf pq", pq_out["rescore"]))}))
    log("durability " + json.dumps(durable))
    log(f"total wall {time.perf_counter() - wall0:.1f} s")

    m = kern["main"]
    no_library = None  # no single PyTorch call computes the IVF probe
    e, c = ivf_kern["expanded"], ivf_kern["compact"]
    e8, c8 = ivf_kern["expanded_int8"], ivf_kern["compact_int8"]
    log(json.dumps({"kernels": [{
        "name": "scan_candidates",
        "route": "cuda",
        "source": "tpuvdb_torch/csrc/scan.cu",
        "replaces": "tpuvdb/kernels/pallas_scan.py:41",
        "launches": launches + launches_serve + launches_clip
        + launches_bench["scan_candidates"]
        + launches_latency["scan_candidates"]
        + mesh_launches["scan_candidates"]
        + launches_ops["scan_candidates"],
        "launches_by_path": {"flat engine": launches,
                             "served (HTTP)": launches_serve,
                             "clip": launches_clip,
                             "bench": launches_bench["scan_candidates"],
                             "latency": launches_latency["scan_candidates"],
                             "mesh": mesh_launches["scan_candidates"],
                             "ops": launches_ops["scan_candidates"]},
        "max_abs_err": max(kern["max_abs_err"],
                           benched["hold_scan"]["max_abs_err"]),
        "ms": m["ms"], "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
        "bound_route": m["bound_route"],
        "library_ms": m["library_ms"],
        # the bench's shape: 1,048,576 x 128 bf16, Q = 512
        "bench_shape": {k: benched["hold_scan"]["rows"][-1][k] for k in
                        ("ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms")},
    }, {
        "name": "ivf_candidates",
        "route": "cuda",
        "source": "tpuvdb_torch/csrc/ivf_probe.cu",
        "replaces": "tpuvdb/kernels/pallas_ivf.py:172",
        "launches": launches_expanded + launches_bench["ivf_candidates"]
        + launches_latency["ivf_candidates"]
        + mesh_launches["ivf_candidates"],
        "launches_by_path": {"ivf engine": launches_expanded,
                             "bench": launches_bench["ivf_candidates"],
                             "latency": launches_latency["ivf_candidates"],
                             "mesh": mesh_launches["ivf_candidates"]},
        "max_abs_err": max(ivf_kern["err_expanded"],
                           benched["hold_probe"]["max_abs_err"]),
        "ms": e["ms"], "plain_ms": e["plain_ms"],
        "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
        "bound_route": e["bound_route"],
        "library_ms": no_library,
        # the bench's IVF shape: 1M x 128 f32, nprobe 64, Q = 8
        "bench_shape": {k: benched["hold_probe"]["row"][k] for k in
                        ("ms", "plain_ms", "bound_ms", "bound_by")},
    }, {
        "name": "ivf_candidates_packed",
        "route": "cuda",
        "source": "tpuvdb_torch/csrc/ivf_probe.cu",
        "replaces": "tpuvdb/kernels/pallas_ivf.py:79",
        "launches": launches_compact,
        "max_abs_err": ivf_kern["err_compact"],
        "ms": c["ms"], "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
        "bound_route": c["bound_route"],
        "library_ms": no_library,
    }, {
        "name": "ivf_candidates_int8",
        "route": "cuda",
        "source": "tpuvdb_torch/csrc/ivf_probe.cu",
        "replaces": "tpuvdb/kernels/pallas_ivf.py:230",
        "launches": launches_expanded_i8
        + cap["capacity_ivf"]["launches"]
        + mesh_launches["ivf_candidates_int8"]
        + launches_ops["ivf_candidates_int8"],
        "launches_by_path": {"ivf int8 engine": launches_expanded_i8,
                             "capacity": cap["capacity_ivf"]["launches"],
                             "mesh": mesh_launches["ivf_candidates_int8"],
                             "ops": launches_ops["ivf_candidates_int8"]},
        "max_abs_err": max(ivf_kern["err_expanded_int8"],
                           cap["capacity_ivf"]["max_abs_err"]),
        "ms": e8["ms"], "plain_ms": e8["plain_ms"],
        "bound_ms": e8["bound_ms"], "bound_by": e8["bound_by"],
        "bound_route": e8["bound_route"],
        "library_ms": no_library,
        # capacity_ivf's index (d = 768, nlist 4,096), Q = 8 and 128
        "capacity_shape": [{k: r[k] for k in
                            ("Q", "nprobe", "ms", "plain_ms", "bound_ms",
                             "bound_by")}
                           for r in cap["capacity_ivf"]["kernel"]],
    }, {
        "name": "ivf_candidates_packed_int8",
        "route": "cuda",
        "source": "tpuvdb_torch/csrc/ivf_probe.cu",
        "replaces": "tpuvdb/kernels/pallas_ivf.py:129",
        "launches": launches_compact_i8,
        "max_abs_err": ivf_kern["err_compact_int8"],
        "ms": c8["ms"], "plain_ms": c8["plain_ms"],
        "bound_ms": c8["bound_ms"], "bound_by": c8["bound_by"],
        "bound_route": c8["bound_route"],
        "library_ms": no_library,
    }, {
        # timed at the capacity shape (8,388,608 x 96 bytes, Q = 256); the
        # engine's own shape (1M x 64 bytes, b256) beside it
        "name": "pq_candidates",
        "route": "cuda",
        "source": "tpuvdb_torch/csrc/pq_probe.cu",
        "replaces": "tpuvdb/kernels/pallas_pq.py:53",
        "launches": launches_pq + cap["capacity_pq"]["launches"]
        + mesh_launches["pq_candidates"] + launches_ops["pq_candidates"],
        "launches_by_path": {"ivf pq engine": launches_pq,
                             "capacity": cap["capacity_pq"]["launches"],
                             "mesh": mesh_launches["pq_candidates"],
                             "ops": launches_ops["pq_candidates"]},
        "max_abs_err": max(pq_kern["max_abs_err"],
                           pq_out["kernel_engine_shape"]["max_abs_err"],
                           cap["capacity_pq"]["max_abs_err"]),
        "ms": pq_kern["main"]["ms"], "plain_ms": pq_kern["main"]["plain_ms"],
        "bound_ms": pq_kern["main"]["bound_ms"],
        "bound_by": pq_kern["main"]["bound_by"],
        "library_ms": no_library,
        "engine_shape": {k: pq_out["kernel_engine_shape"][k] for k in
                         ("ms", "plain_ms", "bound_ms", "bound_by")},
        # capacity_pq's engine index (d = 768, 96 B, nlist 4,096), Q = 8
        # and 256 at its nprobe
        "capacity_shape": [{k: r[k] for k in
                            ("Q", "ms", "plain_ms", "bound_ms", "bound_by")}
                           for r in cap["capacity_pq"]["kernel"]],
    }]}))
    log(_card())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Kernel times of one tree's PyTorch/CUDA port at chip_smoke.py's main
shapes, on one CUDA card, to compare two trees in one call:

    python3 scripts/torch_kernel_ab.py DIR [--ivf-engine]

DIR holds a tpuvdb_torch/ (`.` for this tree; a `git archive` of another
commit unpacked into an ignored directory for the other). It prints one line
`AB {...}`, each figure the mean of CUDA-event timed calls of the wrapper:

  * the scan at Q = 1/64/256 over 1,048,576 x 512 seeded rows;
  * the f32/bf16 IVF probe at Q = 1/8/256 (expanded) and 1,024 (compact)
    on chip_smoke.py's clustered index (nlist 1,024, nprobe 64);
  * the int8 IVF probe at the same Qs, on the same index's rows quantized
    per row (quantize_rows, the engine's quantizer);
  * the IVF-PQ probe at the engine's shape (the same index's cells and
    lists, 64 seeded random code bytes a row, 256 codes a subspace, fetch
    640, Q = 256) and at chip_smoke.py's capacity shape (8,388,608 rows x 96
    bytes, nlist 4,096 of 2,048 rows, nprobe 64, fetch 640, Q = 256).

Run the trees in turns (A, B, B, A). --ivf-engine (this tree only) then
runs chip_smoke.py's IVF engine phase and prints `IVFENG {...}`.

    python3 scripts/torch_kernel_ab.py . --variants

instead times what holds the probe kernels back, on this tree: the probes
under other launch settings and in variant builds that drop or change one
part of the kernel. The variant sources are copies of tpuvdb_torch/csrc/
edited as text in a temporary directory and built there with the
library's own nvcc command; the tree is not touched. It prints one line
`VARIANTS {...}` (ms), and for each variant that keeps the result whether
it equals the shipped kernel's:

  IVF probe, int8 and bf16 cells, Q = 256 (expanded) and 1,024 (compact):
    base           the kernel as shipped
    no_products    the consumers issue no wgmma (the loads, the waits and
                   the epilogue stay; scores are garbage)
    no_epilogue    the epilogue returns at once (the loads and the products
                   stay; nothing is folded)
    load_first     each live score loads its slot's key and folds only if it
                   would win (one L2 round trip a score), in place of the
                   reduction that asks for no old value
    blocks/SM=B    the shipped kernel with ivf_probe.BLOCKS_PER_SM = B
  PQ probe at the engine and capacity shapes:
    teams=T blocks/SM=B G<=G   pq_probe.TEAMS, BLOCKS_PER_SM and the widest
                               query group
    load_first     as above, in fold_key
"""
import json
import os
import shutil
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def cuda_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def ivf_setup(dev):
    """chip_smoke.py's clustered 1,048,576 x 512 IVF index (nlist 1,024)
    and its 1,024 queries."""
    from tpuvdb_torch.index.ivf import IVFIndex

    gen = torch.Generator(device=dev).manual_seed(2)
    centers = torch.randn((1024, 512), generator=gen, device=dev) * 3
    assign = torch.randint(0, 1024, (1 << 20,), generator=gen, device=dev)
    corpus = centers[assign] + 0.4 * torch.randn((1 << 20, 512),
                                                 generator=gen, device=dev)
    qi = torch.randint(0, 1 << 20, (1024,), generator=gen, device=dev)
    queries = corpus[qi] + 0.05 * torch.randn((1024, 512), generator=gen,
                                              device=dev)
    idx = IVFIndex.build(corpus.cpu().numpy(), np.ones(1 << 20, bool),
                         nlist=1024, nprobe=64, kmeans_iters=6,
                         train_sample=131072)
    return idx, queries


def probe_cases(ivf_probe, idx):
    """(Q, nprobe) of the probe timings: the expanded form at Q = 1, 8,
    256 and the compact one at Q = 1,024 above 2**20 entries."""
    w128 = idx.cell_pad // 128
    return ((1, 64), (8, 64), (256, 64),
            (1024, ivf_probe.EXPANDED_MAX // (1024 * w128) + 1))


def pq_engine_args(pq_probe, dev, idx, queries):
    """The IVF index's cells and lists with 64 random code bytes a row."""
    pgen = torch.Generator(device=dev).manual_seed(5)
    n_g = idx.grouped.shape[0]
    codes = torch.randint(0, 256, (n_g, 64), generator=pgen, device=dev,
                          dtype=torch.uint8)
    cb = torch.randn((64, 256, 8), generator=pgen, device=dev) * 0.2
    plan, lut, cellof, bias = pq_probe.pq_probe_inputs(
        queries[:256], idx.centroids, cb, idx.grouped_valid, idx.grouped_sq,
        idx.cell_offsets, idx.cell_pad, 640, 64, n_g)
    return (lut, plan.qc2, plan.cells, plan.segs, cellof, codes, bias,
            plan.n_segments, plan.query_tile)


def pq_capacity_args(pq_probe, dev):
    """chip_smoke.py's capacity shape: 8,388,608 x 96 bytes, Q = 256."""
    pgen = torch.Generator(device=dev).manual_seed(4)
    n_g, nlist, cell = 4096 * 2048, 4096, 2048
    codes = torch.randint(0, 256, (n_g, 96), generator=pgen, device=dev,
                          dtype=torch.uint8)
    cb = torch.randn((96, 256, 8), generator=pgen, device=dev) * 0.2
    cents = torch.randn((nlist, 768), generator=pgen, device=dev)
    sq = torch.rand(n_g, generator=pgen, device=dev) * 100.0 + 700.0
    valid = torch.rand(n_g, generator=pgen, device=dev) >= 0.01
    offs = torch.arange(nlist, dtype=torch.int32, device=dev) * cell
    qq = torch.randn((256, 768), generator=pgen, device=dev)
    plan, lut, cellof, bias = pq_probe.pq_probe_inputs(
        qq, cents, cb, valid, sq, offs, cell, 640, 64, n_g)
    return (lut, plan.qc2, plan.cells, plan.segs, cellof, codes, bias,
            plan.n_segments, plan.query_tile)


LOAD_FIRST = (
    "probe_common.cuh",
    "  if (score > kNegInf) atomicMax(slot, make_key(score, low));",
    "  if (!(score > kNegInf)) return;\n"
    "  const unsigned long long key = make_key(score, low);\n"
    "  if (key > __ldcg(slot)) atomicMax(slot, key);")
IVF_EDITS = {
    "no_products": [
        ("hopper_mma.cuh",
         "        wgmma_s8<N>(acc, da + 2 * ks, db + 2 * ks, keep);", ""),
        ("hopper_mma.cuh",
         "        wgmma_bf16<N>(acc, da + 2 * ks, db + 2 * ks, keep);", "")],
    "no_epilogue": [
        ("ivf_probe.cu",
         "    const int t = threadIdx.x % 128;\n    const int r_lo",
         "    if (block.x >= 0) return;\n"
         "    const int t = threadIdx.x % 128;\n    const int r_lo")],
    "load_first": [LOAD_FIRST],
}


def variant(tmp, source, headers, bind, name, edits):
    """A CudaLibrary of `source` with `edits` (file, old, new) applied to
    copies in tmp/name."""
    from tpuvdb_torch.kernels.cuda_build import CSRC_DIR, CudaLibrary

    d = os.path.join(tmp, name)
    os.makedirs(d)
    for f in (source,) + headers:
        shutil.copy(os.path.join(CSRC_DIR, f), d)
    for f, old, new in edits:
        path = os.path.join(d, f)
        text = open(path).read()
        if old not in text:
            raise RuntimeError(f"{name}: {f} no longer holds {old!r}")
        open(path, "w").write(text.replace(old, new))
    return CudaLibrary(os.path.join(d, source), os.path.join(d, "lib.so"),
                       bind, headers=[os.path.join(d, h) for h in headers])


def same(a, b) -> bool:
    return bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))


def variants() -> None:
    """--variants: see the module's docstring."""
    from tpuvdb_torch.kernels import ivf_probe, pq_probe
    from tpuvdb_torch.kernels.quant import quantize_rows

    tmp = tempfile.mkdtemp()
    ivf_libs = {n: variant(tmp, "ivf_probe.cu",
                           ("hopper_mma.cuh", "probe_common.cuh"),
                           ivf_probe._bind, n, e)
                for n, e in IVF_EDITS.items()}
    pq_load = variant(tmp, "pq_probe.cu", ("probe_common.cuh",),
                      pq_probe._bind, "pq_load_first", [LOAD_FIRST])
    libs = [ivf_probe.LIBRARY, pq_probe.LIBRARY, pq_load,
            *ivf_libs.values()]
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(), libs))

    out = {}
    dev = torch.device("cuda")
    idx, queries = ivf_setup(dev)
    mask = torch.zeros(idx.grouped_valid.shape, device=dev)
    codes8, scales8 = quantize_rows(idx.grouped)
    cells = {"int8": (codes8, {"cell_scales": scales8}),
             "bf16": (idx.grouped.to(torch.bfloat16), {})}
    w128 = idx.cell_pad // 128
    plans = {nq: ivf_probe.probe_plan(queries[:nq], idx.centroids,
                                      idx.cell_offsets, idx.cell_pad, 10,
                                      nprobe)
             for nq, nprobe in ((256, 64), (1024, ivf_probe.EXPANDED_MAX
                                            // (1024 * w128) + 1))}

    def run(dt, nq):
        g, kw = cells[dt]
        return lambda: ivf_probe.plan_candidates(plans[nq], g,
                                                 idx.grouped_sq, mask, **kw)

    shipped = ivf_probe.LIBRARY
    for dt in cells:
        want = run(dt, 256)()
        ivf_probe.LIBRARY = ivf_libs["load_first"]
        out[f"ivf {dt} load_first equal"] = same(run(dt, 256)(), want)
        ivf_probe.LIBRARY = shipped
    blocks = ivf_probe.BLOCKS_PER_SM
    for dt in cells:
        for nq in plans:
            out[f"ivf {dt} Q={nq} base"] = cuda_ms(run(dt, nq), 5)
            for name, lib in ivf_libs.items():
                ivf_probe.LIBRARY = lib
                out[f"ivf {dt} Q={nq} {name}"] = cuda_ms(run(dt, nq), 5)
            ivf_probe.LIBRARY = shipped
            for b in (4, 8, 16, 32):
                ivf_probe.BLOCKS_PER_SM = b
                out[f"ivf {dt} Q={nq} blocks/SM={b}"] = cuda_ms(run(dt, nq),
                                                               5)
            ivf_probe.BLOCKS_PER_SM = blocks
    del codes8, scales8, cells
    torch.cuda.empty_cache()

    setting = (pq_probe.TEAMS, pq_probe.BLOCKS_PER_SM, pq_probe.GROUPS)
    grid = [(t, b, setting[2]) for t in (2, 4, 8) for b in (2, 8, 16)]
    grid += [(setting[0], setting[1], (2, 1)), (setting[0], setting[1], (1,))]
    for name, make in (
            ("engine", lambda: pq_engine_args(pq_probe, dev, idx, queries)),
            ("capacity", lambda: pq_capacity_args(pq_probe, dev))):
        args = make()
        want = pq_probe.pq_candidates(*args)
        shipped = pq_probe.LIBRARY
        pq_probe.LIBRARY = pq_load
        out[f"pq {name} load_first equal"] = same(
            pq_probe.pq_candidates(*args), want)
        out[f"pq {name} load_first"] = cuda_ms(
            lambda: pq_probe.pq_candidates(*args), 5)
        pq_probe.LIBRARY = shipped
        for teams, b, groups in grid:
            pq_probe.TEAMS, pq_probe.BLOCKS_PER_SM, pq_probe.GROUPS = (
                teams, b, groups)
            out[f"pq {name} teams={teams} blocks/SM={b} G<={groups[0]}"] = (
                cuda_ms(lambda: pq_probe.pq_candidates(*args), 5))
        pq_probe.TEAMS, pq_probe.BLOCKS_PER_SM, pq_probe.GROUPS = setting
        del args, want
        torch.cuda.empty_cache()
    print("VARIANTS " + json.dumps(out), flush=True)


def main() -> None:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import tpuvdb_torch
    assert tpuvdb_torch.__file__.startswith(root), tpuvdb_torch.__file__
    if "--variants" in sys.argv[2:]:
        variants()
        return
    from tpuvdb_torch.kernels import ivf_probe, pq_probe, scan
    from tpuvdb_torch.kernels.quant import quantize_rows

    out = {"tree": sys.argv[1]}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    x32 = torch.randn((1 << 20, 512), generator=gen, device=dev)
    q = torch.randn((256, 512), generator=gen, device=dev)
    m = torch.zeros(1 << 20, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        x = x32.to(dt)
        s = x.float().pow(2).sum(1)
        for nq in (1, 64, 256):
            out[f"scan {str(dt)[6:]} Q={nq}"] = cuda_ms(
                lambda: scan.scan_candidates(q[:nq], x, s, m, 512), 10)
    del x32, x
    torch.cuda.empty_cache()
    idx, queries = ivf_setup(dev)
    mask = torch.zeros(idx.grouped_valid.shape, device=dev)
    codes8, scales8 = quantize_rows(idx.grouped)
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        g = codes8 if dt == torch.int8 else idx.grouped.to(dt)
        kw = {"cell_scales": scales8} if dt == torch.int8 else {}
        for nq, nprobe in probe_cases(ivf_probe, idx):
            plan = ivf_probe.probe_plan(queries[:nq], idx.centroids,
                                        idx.cell_offsets, idx.cell_pad, 10,
                                        nprobe)
            out[f"probe {str(dt)[6:]} Q={nq}"] = cuda_ms(
                lambda: ivf_probe.plan_candidates(plan, g, idx.grouped_sq,
                                                  mask, **kw),
                10 if nq <= 8 else 5)
    del g, codes8, scales8
    torch.cuda.empty_cache()
    for name, args in (
            ("engine", lambda: pq_engine_args(pq_probe, dev, idx, queries)),
            ("capacity", lambda: pq_capacity_args(pq_probe, dev))):
        a = args()
        out[f"pq {name} Q=256"] = cuda_ms(
            lambda: pq_probe.pq_candidates(*a), 5)
        del a
        torch.cuda.empty_cache()
    print("AB " + json.dumps(out), flush=True)

    if "--ivf-engine" in sys.argv[2:]:
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        import chip_smoke as cs

        del idx
        torch.cuda.empty_cache()
        _, _, _, _, _, res = cs.phase_ivf_engine(tpuvdb_torch)
        print("IVFENG " + json.dumps({k: res[k] for k in (
            "b1", "b8", "b32", "b256", "b256_device", "recall_at_10")}),
            flush=True)


if __name__ == "__main__":
    main()

"""Kernel times of one tree's PyTorch/CUDA port at chip_smoke.py's main
shapes, on one CUDA card, to compare two trees in one call:

    python3 scripts/torch_kernel_ab.py DIR [--ivf-engine]

DIR holds a tpuvdb_torch/ (`.` for this tree; a `git archive` of another
commit unpacked into an ignored directory for the other). It prints one line
`AB {...}`: the scan at Q = 1/64/256 over 1,048,576 x 512 seeded rows, and
the f32/bf16 IVF probe at Q = 1/8/256 (expanded) and 1,024 (compact) on
chip_smoke.py's clustered index, each the mean of CUDA-event timed calls of
the wrapper. Run the trees in turns (A, B, B, A). --ivf-engine (this tree
only) then runs chip_smoke.py's IVF engine phase and prints `IVFENG {...}`.
"""
import json, os, sys
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
import numpy as np
import torch
import tpuvdb_torch
assert tpuvdb_torch.__file__.startswith(root), tpuvdb_torch.__file__
from tpuvdb_torch.kernels import scan, ivf_probe
from tpuvdb_torch.index.ivf import IVFIndex


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
gen = torch.Generator(device=dev).manual_seed(2)
centers = torch.randn((1024, 512), generator=gen, device=dev) * 3
assign = torch.randint(0, 1024, (1 << 20,), generator=gen, device=dev)
corpus = centers[assign] + 0.4 * torch.randn((1 << 20, 512), generator=gen,
                                             device=dev)
qi = torch.randint(0, 1 << 20, (1024,), generator=gen, device=dev)
queries = corpus[qi] + 0.05 * torch.randn((1024, 512), generator=gen,
                                          device=dev)
idx = IVFIndex.build(corpus.cpu().numpy(), np.ones(1 << 20, bool), nlist=1024,
                     nprobe=64, kmeans_iters=6, train_sample=131072)
del corpus
mask = torch.zeros(idx.grouped_valid.shape, device=dev)
w128 = idx.cell_pad // 128
for dt in (torch.float32, torch.bfloat16):
    g = idx.grouped.to(dt)
    for nq, nprobe in ((1, 64), (8, 64), (256, 64),
                       (1024, ivf_probe.EXPANDED_MAX // (1024 * w128) + 1)):
        plan = ivf_probe.probe_plan(queries[:nq], idx.centroids,
                                    idx.cell_offsets, idx.cell_pad, 10, nprobe)
        out[f"probe {str(dt)[6:]} Q={nq}"] = cuda_ms(
            lambda: ivf_probe.plan_candidates(plan, g, idx.grouped_sq, mask),
            10 if nq <= 8 else 5)
print("AB " + json.dumps(out), flush=True)

if "--ivf-engine" in sys.argv[2:]:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    import tpuvdb_torch as tt

    del idx, g
    torch.cuda.empty_cache()
    _, _, _, _, _, res = cs.phase_ivf_engine(tt)
    print("IVFENG " + json.dumps({k: res[k] for k in (
        "b1", "b8", "b32", "b256", "b256_device", "recall_at_10")}),
        flush=True)

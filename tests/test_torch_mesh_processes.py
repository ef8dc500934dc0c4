"""The mesh across processes: two gloo processes of two CPU slots each.

The reference's mesh programs are one SPMD program over a global mesh.
Here every worker makes the same calls on the same data and must get the
whole answer back, equal (rows and distances) to the same calls on a mesh
of the same shape inside one process, which each worker also runs. The
workers never import jax; they write their answers to an .npz, and the
test process holds both ranks' answers equal and against the JAX package's
mesh programs on the conftest's virtual CPU devices.

Mesh layouts of the 4 slots (process 0 brings slots 0-1, process 1 slots
2-3):
* "1d": (shards,) = 4: two shards a process.
* "2x2": `create_mesh_2d(2, 2)`, (repl, shards): each replica group lies
  in one process.
* "2x2span": `build_mesh(devs, ("shards", "repl"), (2, 2))`: each group
  holds one slot of each process.

Scenarios, one worker script each:
* `replicated_search` f32 "exact" and "approx" and int8 with a per-slot
  re-rank (`rescore_fetch` 8), at b5 (padded to the groups) and b8, on
  both 2-D layouts.
* `ShardedIVFIndex` (f32, int8 and PQ cells) on "1d" and "2x2": a cold
  build (k-means and PQ training in one process, broadcast), host tables
  equal on both ranks and to the one-process build's, a search with every
  cell probed, appends into the cells and the spill, deletes, a search
  again, and a filtered search.
* `VectorDBEngine`: IVF on "1d" and "2x2", flat on "2x2": puts, flush,
  search, deletes, a delta-overflow append, a search of the appended
  rows, a filtered search, and (IVF "1d") a warm restart from each
  process's own data_dir; the JAX engine runs the same ops on the same
  mesh shape in the test process, and the IVF engines take its trained
  centroids.
"""

import inspect
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from test_torch_mesh_sharded import assert_rows_equal_outside_ties
from test_torch_sharded_ivf import clustered
from tpuvdb.mesh.mesh import create_mesh as jax_create_mesh
from tpuvdb.mesh.replicated import create_mesh_2d as jax_mesh_2d
from tpuvdb.mesh.replicated import replicated_search as jax_replicated
from tpuvdb.mesh.replicated import shard_corpus_replicated as jax_place
from tpuvdb.mesh.sharded_ivf import ShardedIVFIndex as JaxSharded
from tpuvdb_torch.kernels.distance import numpy_oracle
from tpuvdb_torch.kernels.quant import quantize_rows_np

PRELUDE = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # an import of jax now raises

    import numpy as np
    import torch
    import torch.distributed as dist

    from tpuvdb_torch.cluster.bootstrap import (initialize_multihost,
                                                shutdown_multihost)
    from tpuvdb_torch.mesh import Mesh
    from tpuvdb_torch.mesh.mesh import build_mesh

    coord, pid, inp, out_path = (sys.argv[1], int(sys.argv[2]), sys.argv[3],
                                 sys.argv[4])
    initialize_multihost(coordinator_address=coord, num_processes=2,
                         process_id=pid)
    assert dist.get_backend() == "gloo"
    data = dict(np.load(inp))
    res = {}
    LAYOUTS = {"1d": (("shards",), (4,)),
               "2x2": (("repl", "shards"), (2, 2)),
               "2x2span": (("shards", "repl"), (2, 2))}


    def meshes(layout):
        \"\"\"(the process mesh, the same shape inside this process).\"\"\"
        axes, shape = LAYOUTS[layout]
        pm = build_mesh([torch.device("cpu")] * 2, axes, shape)
        assert pm.distributed and pm.local_slots() == [2 * pid, 2 * pid + 1]
        one = np.empty(4, object)
        one[:] = [torch.device("cpu")] * 4
        return pm, Mesh(one.reshape(shape), axes)


    def same(a, b, what):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and (a == b).all(), (what, a, b)
""")

EPILOGUE = textwrap.dedent("""
    np.savez(out_path, **res)
    shutdown_multihost()
    assert sys.modules["jax"] is None
    print(f"proc {pid}: ok", flush=True)
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_workers(tmp_path, body: str, inputs: dict) -> list:
    """Two workers run PRELUDE + body + EPILOGUE on `inputs`; returns each
    rank's saved answers."""
    script = tmp_path / "worker.py"
    script.write_text(PRELUDE + textwrap.dedent(body) + EPILOGUE)
    inp = tmp_path / "inputs.npz"
    np.savez(inp, **inputs)
    coord = f"127.0.0.1:{_free_port()}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    outs = [tmp_path / f"rank{pid}.npz" for pid in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), coord, str(pid), str(inp),
         str(outs[pid])], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=str(tmp_path)) for pid in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{log}"
        assert f"proc {pid}: ok" in log
    got = [dict(np.load(o)) for o in outs]
    assert got[0].keys() == got[1].keys()
    for name in got[0]:
        np.testing.assert_array_equal(got[0][name], got[1][name],
                                      err_msg=name)
    return got


# ------------------------------------------------------- replicated search

REPLICATED = """
    from tpuvdb_torch.mesh.replicated import (pad_to_groups,
                                              replicated_search,
                                              shard_corpus_replicated)
    from tpuvdb_torch.mesh.sharded import shard_rows

    corpus, sq, valid, q = data["corpus"], data["sq"], data["valid"], \\
        data["q"]
    ci8, scales, sq8 = data["ci8"], data["scales"], data["sq8"]
    for layout in ("2x2", "2x2span"):
        pm, one = meshes(layout)
        for b in (5, 8):
            qb, qn = pad_to_groups(q[:b], 2)
            for mode in ("exact", "approx", "int8"):
                outs = []
                for m in (pm, one):
                    if mode == "int8":
                        d, r = replicated_search(
                            qb, *shard_corpus_replicated(m, ci8, sq8, valid),
                            k=10, block_size=128, mesh=m,
                            row_scales=shard_rows(m, scales),
                            rescore_fetch=8)
                    else:
                        d, r = replicated_search(
                            qb, *shard_corpus_replicated(m, corpus, sq,
                                                         valid),
                            k=10, block_size=128, mesh=m, mode=mode)
                    outs.append((d[:qn].numpy(), r[:qn].numpy()))
                (d, r), (d1, r1) = outs
                same(r, r1, (layout, b, mode))
                same(d, d1, (layout, b, mode))
                res[f"{layout}_{mode}_b{b}_d"] = d
                res[f"{layout}_{mode}_b{b}_r"] = r
"""


def test_replicated_search_across_processes(tmp_path):
    rng = np.random.default_rng(0)
    rows, dim = 2 * 256, 16
    corpus = rng.standard_normal((rows, dim)).astype(np.float32)
    valid = np.ones(rows, bool)
    valid[[3, 300]] = False
    sq = np.einsum("nd,nd->n", corpus, corpus).astype(np.float32)
    ci8, scales = quantize_rows_np(corpus)
    stored = ci8.astype(np.float32) * scales[:, None]
    sq8 = np.einsum("nd,nd->n", stored, stored).astype(np.float32)
    q = rng.standard_normal((8, dim)).astype(np.float32)
    got = run_workers(tmp_path, REPLICATED, dict(
        corpus=corpus, sq=sq, valid=valid, q=q, ci8=ci8, scales=scales,
        sq8=sq8))[0]
    jmesh = jax_mesh_2d(2, 2, devices=jax.devices()[:4])
    sharded = NamedSharding(jmesh, P("shards"))
    for b in (5, 8):
        qb = np.concatenate([q[:b], np.zeros((b % 2, dim), np.float32)])
        jd, jr = jax_replicated(
            jnp.asarray(qb), *jax_place(jmesh, jnp.asarray(corpus),
                                        jnp.asarray(sq), jnp.asarray(valid)),
            k=10, block_size=128, mesh=jmesh, mode="exact")
        j8d, j8r = jax_replicated(
            jnp.asarray(qb), *jax_place(jmesh, jnp.asarray(ci8),
                                        jnp.asarray(sq8), jnp.asarray(valid)),
            k=10, block_size=128, mesh=jmesh,
            row_scales=jax.device_put(jnp.asarray(scales), sharded),
            rescore_fetch=8)
        _, oidx = numpy_oracle(q[:b], corpus, valid, 10)
        for layout in ("2x2", "2x2span"):
            key = f"{layout}_%s_b{b}_%s"
            assert_rows_equal_outside_ties(
                got[key % ("exact", "d")], got[key % ("exact", "r")],
                np.asarray(jd)[:b], np.asarray(jr)[:b])
            assert_rows_equal_outside_ties(
                got[key % ("int8", "d")], got[key % ("int8", "r")],
                np.asarray(j8d)[:b], np.asarray(j8r)[:b])
            approx = got[key % ("approx", "r")]
            recall = np.mean([len(set(approx[i]) & set(oidx[i])) / 10
                              for i in range(b)])
            assert recall >= 0.95, (layout, b, recall)


# -------------------------------------------------------- sharded IVF index

IVF = """
    from tpuvdb_torch.mesh.mesh import check_same_everywhere
    from tpuvdb_torch.mesh.sharded_ivf import ShardedIVFIndex

    vecs, valid, q = data["vecs"], data["valid"], data["q"]
    new, dead, cand = data["new"], data["dead"], data["cand"]
    appended = np.flatnonzero(~valid)
    # a digest mismatch raises on every rank
    try:
        check_same_everywhere(build_mesh([torch.device("cpu")] * 2,
                                         ("shards",)), "a probe", str(pid))
        raise AssertionError("unequal digests passed")
    except RuntimeError as e:
        assert "differ between processes" in str(e)
    for layout in ("1d", "2x2"):
        pm, one = meshes(layout)
        repl = "repl" if layout == "2x2" else None
        for cells in ("f32", "int8", "pq"):
            kw = dict(nlist=4, nprobe=2, kmeans_iters=3, repl_axis=repl,
                      dtype=torch.int8 if cells == "int8" else torch.float32,
                      pq_subq=8 if cells == "pq" else 0)
            tag = f"{layout}_{cells}"
            # cold: each shard's k-means in one process, broadcast
            cold = [ShardedIVFIndex.build(vecs, valid, m, **kw)
                    for m in (pm, one)]
            same(cold[0].host_digest(), cold[1].host_digest(), tag)
            res[f"{tag}_cold_digest"] = cold[0].host_digest()
            outs = [t.search(q, k=10) for t in cold]
            for a, b in zip(*outs):
                same(a, b, (tag, "cold"))
            # warm from the reference's tables: the rest of the checks
            warm = {"centroids": data[f"{tag}_centroids"]}
            if cells == "pq":
                warm["pq_codebooks"] = data[f"{tag}_codebooks"]
            answers = []
            for m in (pm, one):
                t = ShardedIVFIndex.build(vecs, valid, m, **warm, **kw)
                out = {"digest0": t.host_digest()}
                full = t.centroids.shape[1]
                out["d0"], out["r0"] = t.search(q, k=10, nprobe=full)
                spill0 = int((t.spill_row_ids >= 0).sum())
                assert t.append_rows(appended, new)
                out["spilled"] = int((t.spill_row_ids >= 0).sum()) - spill0
                t.invalidate_rows(dead)
                out["d1"], out["r1"] = t.search(q, k=10, nprobe=full)
                out["d2"], out["r2"] = t.search(
                    q[:4], k=5, nprobe=full,
                    valid_override=t.masked_valid(cand))
                out["digest1"] = t.host_digest()
                out["stats"] = np.asarray(
                    [float(v) for v in vars(t.stats()).values()])
                out["nbytes"] = t.nbytes()
                for name in ("cell_lens", "row_ids", "spill_row_ids"):
                    out[name] = getattr(t, name)
                answers.append(out)
            got, want = answers
            assert got.keys() == want.keys()
            for name in got:
                same(got[name], want[name], (layout, cells, name))
            assert got["spilled"] > 0, (layout, cells)
            res.update({f"{tag}_{n}": v for n, v in got.items()})
"""


@pytest.fixture(scope="module")
def ivf_runs(tmp_path_factory):
    rng = np.random.default_rng(1)
    # unit-scale rows, as the reference-parity test with every cell probed
    # takes: the expanded-form distances keep rtol 1e-5
    vecs = rng.standard_normal((1536, 16)).astype(np.float32)
    valid = np.ones(len(vecs), bool)
    # every shard leaves rows unwritten at build time, appended after:
    # 40 a shard of "1d", in one cell's neighbourhood, so some spill
    per = len(vecs) // 4
    off = np.concatenate([np.arange(s * per + 300, s * per + 340)
                          for s in range(4)])
    valid[off] = False
    new = (vecs[0] + 0.05 * rng.standard_normal((len(off), 16))).astype(
        np.float32)
    vecs = vecs.copy()
    vecs[off] = new
    dead = np.array([5, 400, 801, 1200, int(off[3])])
    cand = rng.choice(np.flatnonzero(valid), 200, replace=False)
    q = vecs[rng.choice(len(vecs), 10, replace=False)] + 0.02
    inputs = dict(vecs=vecs, valid=valid, q=q, new=new, dead=dead,
                  cand=cand)
    # the reference's cold tables: both packages build warm from them
    # (the layout is then bit-equal, tests/test_torch_sharded_ivf.py)
    warm = {}
    for layout in ("1d", "2x2"):
        for cells in ("f32", "int8", "pq"):
            tag = f"{layout}_{cells}"
            jmesh, repl = _jax_mesh(layout)
            j = JaxSharded.build(vecs, valid, jmesh, repl_axis=repl,
                                 **_jax_kw(cells))
            inputs[f"{tag}_centroids"] = np.asarray(j.centroids)
            warm[tag] = {"centroids": inputs[f"{tag}_centroids"]}
            if cells == "pq":
                inputs[f"{tag}_codebooks"] = np.asarray(j.pq_codebooks)
                warm[tag]["pq_codebooks"] = inputs[f"{tag}_codebooks"]
    tmp = tmp_path_factory.mktemp("ivf_processes")
    got = run_workers(tmp, IVF, inputs)[0]
    return got, dict(inputs, appended=off, warm=warm)


def _jax_mesh(layout):
    """(the JAX mesh of a layout, its replica axis)."""
    if layout == "2x2":
        return jax_mesh_2d(2, 2, devices=jax.devices()[:4]), "repl"
    return jax_create_mesh(4), None


def _jax_kw(cells):
    kw = dict(nlist=4, nprobe=2, kmeans_iters=3,
              dtype=jnp.int8 if cells == "int8" else jnp.float32)
    if cells == "pq":
        kw["pq_subq"] = 8
    return kw


def _jax_twin(inputs, layout, cells):
    """The JAX index warm from the tables the port's warm build took, put
    through the same appends, deletes and searches. Returns its
    answers."""
    jmesh, repl = _jax_mesh(layout)
    j = JaxSharded.build(inputs["vecs"], inputs["valid"], jmesh,
                         repl_axis=repl, **inputs["warm"][f"{layout}_{cells}"],
                         **_jax_kw(cells))
    full = int(np.asarray(j.centroids).shape[1])
    out = {}
    out["d0"], out["r0"] = j.search(inputs["q"], k=10, nprobe=full)
    assert j.append_rows(inputs["appended"], inputs["new"])
    j.invalidate_rows(inputs["dead"])
    out["d1"], out["r1"] = j.search(inputs["q"], k=10, nprobe=full)
    out["d2"], out["r2"] = j.search(
        inputs["q"][:4], k=5, nprobe=full,
        valid_override=j.masked_valid(inputs["cand"]))
    for name in ("cell_lens", "row_ids", "spill_row_ids"):
        out[name] = np.asarray(getattr(j, name))
    return {n: np.asarray(v) for n, v in out.items()}


@pytest.mark.parametrize("layout", ["1d", "2x2"])
@pytest.mark.parametrize("cells", ["f32", "int8", "pq"])
def test_sharded_ivf_across_processes(ivf_runs, layout, cells):
    """Both ranks' answers are equal to each other and to the one-process
    build's (in the workers); host tables equal before and after the
    writes; the reference, warm from the same tables, lands the appends
    in the same cells and spill slots and answers alike."""
    got, inputs = ivf_runs
    tag = f"{layout}_{cells}"
    assert got[f"{tag}_digest0"] != got[f"{tag}_digest1"]
    j = _jax_twin(inputs, layout, cells)
    for name in ("cell_lens", "row_ids", "spill_row_ids"):
        np.testing.assert_array_equal(got[f"{tag}_{name}"], j[name])
    for step, k in (("0", 10), ("1", 10), ("2", 5)):
        d_t, r_t = got[f"{tag}_d{step}"], got[f"{tag}_r{step}"]
        d_j, r_j = j[f"d{step}"], j[f"r{step}"]
        assert d_t.shape == d_j.shape
        if cells == "f32":
            assert_rows_equal_outside_ties(d_t, r_t, d_j, r_j)
        else:
            # int8: the probe scores the quantized query batch (the
            # reference's CPU gather f32 queries); PQ: the PQ probe's twin
            # against the reference's XLA ADC gather. The same candidates.
            overlap = np.mean([len(set(r_t[i]) & set(r_j[i])) / k
                               for i in range(len(r_t))])
            assert overlap >= 0.9, (step, overlap)
        assert not set(r_t.ravel()) & set(inputs["dead"].tolist())
    assert set(got[f"{tag}_r2"].ravel()) <= set(inputs["cand"].tolist())
    assert got[f"{tag}_nbytes"] > 0


# ----------------------------------------------------------------- engine

ENGINE_BASE = dict(vector_dim=16, shard_count=2, shard_capacity=4096,
                   block_size=128, checkpoint_every_puts=10**9,
                   compact_every_puts=10**9)
ENGINE_IVF = dict(index_type="ivf", ivf_nlist=16, ivf_nprobe=2,
                  ivf_kmeans_iters=3, ivf_delta_max=16)
ENGINE_CASES = {"ivf_1d": ENGINE_IVF, "ivf_2x2": ENGINE_IVF,
                "flat_2x2": dict(search_mode="exact")}
ENGINE_DEAD = ("k3", "k10", "k500")
ENGINE_NEW = 48  # rows put after the first flush: the delta overflows


def drive_engine(eng, vecs, q, VectorData, warm=None):
    """The engine scenario, the same op for op in both packages. `warm`,
    the reference's per-shard centroid table, seeds the first IVF build
    as a checkpoint's would (the same cells in both packages, as
    tests/test_torch_sharded_ivf.py shows for the index)."""
    keys = [f"k{i}" for i in range(len(vecs))]
    n0 = len(vecs) - ENGINE_NEW
    out = {}
    meta = [{"g": str(i % 3)} for i in range(n0)]
    assert eng.put_rows(keys[:n0], vecs[:n0], metadatas=meta).success
    if warm is not None:
        eng._ivf_warm = (warm, n0, eng._mut_count)
    eng.flush()
    if getattr(eng, "_ivf", None) is not None:
        out["cents"] = eng._ivf.centroids
    out["d0"], out["k0"] = eng.search_batch(q, 10)
    for key in ENGINE_DEAD:
        assert eng.delete(key).success
    # more new rows than ivf_delta_max: the delta overflows and the rows
    # append into the cells and spill
    assert eng.put_batch([VectorData(key=keys[i], vector=vecs[i])
                          for i in range(n0, len(vecs))]).success
    eng.flush()
    out["d1"], out["k1"] = eng.search_batch(q, 10)
    # the appended rows themselves: each must be found in its cell
    out["d3"], out["k3"] = eng.search_batch(vecs[n0:n0 + 8] + 0.01, 10)
    eng._FILTER_DEVICE_MIN = 50
    hits = eng.search_hits(q[0], 8, filter_metadata={"g": "1"})
    out["filtered"] = [h.key for h in hits]
    out["filtered_d"] = [h.score for h in hits]
    out["device_bytes"] = eng.info()["device_bytes"]
    out["appends"] = eng.stats.get("ivf_appends", 0)
    return {n: np.asarray(v) for n, v in out.items()}


# the workers import no jax, so not this module: they take its engine
# scenario as source
ENGINE = (f"ENGINE_BASE = {ENGINE_BASE!r}\nENGINE_CASES = {ENGINE_CASES!r}\n"
          f"ENGINE_DEAD = {ENGINE_DEAD!r}\nENGINE_NEW = {ENGINE_NEW!r}\n\n"
          + inspect.getsource(drive_engine) + textwrap.dedent("""
    import os
    from tpuvdb_torch import DBConfig, VectorDBEngine
    from tpuvdb_torch.core.types import VectorData

    vecs, q = data["vecs"], data["q"]
    for case, kw in ENGINE_CASES.items():
        layout = case.split("_")[1]
        warm = data.get(f"{case}_cents")
        pm, one = meshes(layout)
        answers = []
        for m, where in ((pm, f"p{pid}"), (one, f"one{pid}")):
            d = (os.path.join(os.getcwd(), f"{case}_{where}")
                 if case == "ivf_1d" else None)
            cfg = DBConfig(**ENGINE_BASE, **kw)
            eng = VectorDBEngine(cfg, data_dir=d, mesh=m, device="cpu")
            out = drive_engine(eng, vecs, q, VectorData, warm)
            eng.close()
            if d is not None:
                # warm restart: each process reopens its own data_dir
                eng = VectorDBEngine(cfg, data_dir=d, mesh=m, device="cpu")
                out["d2"], out["k2"] = eng.search_batch(q, 10)
                eng.close()
            answers.append(out)
        got, want = answers
        assert got.keys() == want.keys()
        for name in got:
            same(got[name], want[name], (case, name))
        if warm is not None:
            same(got["cents"], warm, (case, "centroids"))
            assert got["appends"] > 0, case
        res.update({f"{case}_{n}": np.asarray(v) for n, v in got.items()})
"""))


def _jax_engine(tmp_path, vecs, q, case):
    """The JAX engine on the same mesh shape, driven cold through the same
    ops (and, for "ivf_1d", the same warm restart)."""
    from tpuvdb.core.config import DBConfig as JaxConfig
    from tpuvdb.core.types import VectorData as JaxVectorData
    from tpuvdb.engine.engine import VectorDBEngine as JaxEngine

    jmesh, _ = _jax_mesh(case.split("_")[1])
    cfg = JaxConfig(**ENGINE_BASE, **ENGINE_CASES[case])
    d = str(tmp_path / f"jax_{case}") if case == "ivf_1d" else None
    eng = JaxEngine(cfg, data_dir=d, mesh=jmesh)
    out = drive_engine(eng, vecs, q, JaxVectorData)
    eng.close()
    if d is not None:
        eng = JaxEngine(cfg, data_dir=d, mesh=jmesh)
        out["d2"], out["k2"] = map(np.asarray, eng.search_batch(q, 10))
        eng.close()
    return out


def test_engine_across_processes(tmp_path):
    """Both ranks' answers equal the one-process mesh engine's (in the
    workers), and the JAX engine's on the same mesh shape: keys and
    distances outside exact ties, through flush, deletes, the
    delta-overflow append, a filtered search and a warm restart. The IVF
    engines take the JAX engine's trained centroids, so both cluster
    alike."""
    rng = np.random.default_rng(2)
    # 1,024 rows at unit scale: the expanded-form distances of the two
    # packages then agree within rtol 1e-5 (at the centres' scale of 5,
    # |x|^2 ~ 400 leaves 1e-4 of f32 rounding in a distance of 1e-3)
    vecs = clustered(rng, 8, 128, 16) / 5
    q = vecs[rng.choice(len(vecs) - ENGINE_NEW, 8, replace=False)] + 0.01
    jax_out = {case: _jax_engine(tmp_path, vecs, q, case)
               for case in ENGINE_CASES}
    inputs = dict(vecs=vecs, q=q)
    for case, j in jax_out.items():
        if "cents" in j:
            inputs[f"{case}_cents"] = j["cents"]
    got = run_workers(tmp_path, ENGINE, inputs)[0]
    for case, j in jax_out.items():
        g = {n[len(case) + 1:]: v for n, v in got.items()
             if n.startswith(case + "_")}
        steps = ("0", "1", "3", "2") if case == "ivf_1d" else ("0", "1", "3")
        for step in steps:
            assert_rows_equal_outside_ties(g[f"d{step}"], g[f"k{step}"],
                                           j[f"d{step}"], j[f"k{step}"])
        assert_rows_equal_outside_ties(
            g["filtered_d"][None], g["filtered"][None],
            j["filtered_d"][None], j["filtered"][None])
        assert not set(ENGINE_DEAD) & set(g["k1"].ravel())
        n0 = len(vecs) - ENGINE_NEW
        assert list(g["k3"][:, 0]) == [f"k{i}" for i in range(n0, n0 + 8)]
        assert len(g["filtered"]) and all(
            int(k[1:]) % 3 == 1 and int(k[1:]) < n0 for k in g["filtered"])
        if case.startswith("ivf"):
            assert g["appends"] > 0 and j["appends"] > 0, case
        else:
            # the exact flat mesh: the oracle's keys after the writes
            live = np.ones(len(vecs), bool)
            live[[int(k[1:]) for k in ENGINE_DEAD]] = False
            _, o1 = numpy_oracle(q, vecs, live, 10)
            np.testing.assert_array_equal(
                g["k1"], np.vectorize(lambda i: f"k{i}")(o1))
    np.testing.assert_array_equal(got["ivf_1d_k2"], got["ivf_1d_k1"])

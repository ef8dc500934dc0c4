"""tpuvdb_torch and chip_smoke.py stand alone: no jax, nothing of tpuvdb.

Only the tests import both packages. The port keeps its own copies of the
host-only modules it needs, so it imports (and runs) where jax is absent.
"""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tpuvdb_torch")

_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|tpuvdb)(\.|\s|,|$)", re.MULTILINE)

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["flax"] = None
import tpuvdb_torch
names = [m.name for m in pkgutil.walk_packages(tpuvdb_torch.__path__,
                                               "tpuvdb_torch.")]
for name in names:
    importlib.import_module(name)
from tpuvdb_torch import VectorDBEngine, DBConfig
leaked = sorted(m for m in sys.modules
                if m == "tpuvdb" or m.startswith("tpuvdb.")
                or m in ("jax", "flax") and sys.modules[m] is not None
                or m.startswith(("jax.", "flax.")))
print(len(names), leaked)
print(" ".join(names))
assert not leaked, leaked
"""

# the modules of the newest slices: the walk must reach them
_MUST_WALK = ("tpuvdb_torch.kernels.pq", "tpuvdb_torch.kernels.pq_probe",
              "tpuvdb_torch.kernels.ivf_probe", "tpuvdb_torch.kernels.quant",
              "tpuvdb_torch.index.ivf", "tpuvdb_torch.store.checkpoint",
              "tpuvdb_torch.engine.engine", "tpuvdb_torch.native",
              "tpuvdb_torch.engine.coalesce", "tpuvdb_torch.core.wire",
              "tpuvdb_torch.api.service", "tpuvdb_torch.api.cli",
              "tpuvdb_torch.cluster.federation",
              "tpuvdb_torch.cluster.bootstrap", "tpuvdb_torch.mesh.mesh",
              "tpuvdb_torch.mesh.sharded", "tpuvdb_torch.mesh.replicated",
              "tpuvdb_torch.mesh.sharded_ivf", "tpuvdb_torch.mesh.dryrun",
              "tpuvdb_torch.embed.bpe", "tpuvdb_torch.embed.clip",
              "tpuvdb_torch.embed.client", "tpuvdb_torch.bench.harness",
              "tpuvdb_torch.bench.recall", "tpuvdb_torch.bench.datasets",
              "tpuvdb_torch.bench.clip_e2e", "tpuvdb_torch.bench.scan",
              "tpuvdb_torch.bench.engine_serving",
              "tpuvdb_torch.bench.streaming", "tpuvdb_torch.utils.hostmem",
              "tpuvdb_torch.utils.vector_utils", "tpuvdb_torch.bench.latency",
              "tpuvdb_torch.bench.capacity",
              "tpuvdb_torch.bench.capacity_engine",
              "tpuvdb_torch.bench.capacity_ivf",
              "tpuvdb_torch.bench.capacity_pq", "tpuvdb_torch.examples",
              "tpuvdb_torch.examples.quickstart",
              "tpuvdb_torch.examples.sharded_serving")


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_without_jax_or_tpuvdb():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    n_modules = int(lines[0].split()[0])
    assert n_modules >= 20  # every subpackage and module was walked
    walked = set(lines[1].split())
    assert not [m for m in _MUST_WALK if m not in walked]


def test_importing_every_module_builds_nothing(tmp_path):
    """The native library builds at first use, never at import: walking
    every module leaves its build directory uncreated."""
    build = tmp_path / "native-build"
    env = dict(os.environ, PYTHONPATH=ROOT,
               TPUVDB_TORCH_NATIVE_BUILD=str(build))
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert not build.exists()


def test_no_source_imports_jax_or_tpuvdb():
    offenders = []
    for path in _sources():
        with open(path) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, ROOT)}: "
                                 f"{m.group(0).strip()}")
    assert not offenders, offenders


def test_forbidden_pattern_allows_the_port_itself():
    assert _FORBIDDEN.search("from jax import numpy")
    assert _FORBIDDEN.search("import tpuvdb.engine")
    assert _FORBIDDEN.search("  from tpuvdb.index import layout")
    assert _FORBIDDEN.search("import jax, numpy")
    assert _FORBIDDEN.search("import flax.linen as nn")
    assert not _FORBIDDEN.search("from tpuvdb_torch.index import layout")
    assert not _FORBIDDEN.search("import tpuvdb_torch")

"""Bulk export and import in the port (tpuvdb_torch/api/cli.py `export` /
`import` and the service's export RPC) against the JAX package's.

Mirrors tests/test_export_import.py on device="cpu" and adds the backup
interchange: a file exported by the JAX CLI imports with the port's CLI,
and the other way round, with keys, vectors and metadata equal. The JAX
services' native library is switched off (the reference's build races
between test workers).
"""

import msgpack
import numpy as np
import pytest
from click.testing import CliRunner

from tpuvdb import native as jax_native
from tpuvdb.api.cli import cli as jax_cli
from tpuvdb.core import wire as jax_wire
from tpuvdb_torch.api.cli import cli
from tpuvdb_torch.api.service import DBService
from tpuvdb_torch.core.config import DBConfig
from tpuvdb_torch.core.types import VectorData

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _no_reference_build(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "rescore_available", lambda: False)
    monkeypatch.setenv("TPUVDB_VECTOR_DIM", "8")


def test_export_rpc_pagination(rng):
    svc = DBService(DBConfig(vector_dim=8, shard_count=2,
                             shard_capacity=1024, block_size=128),
                    device="cpu")
    for i in range(25):
        svc.engine.put(VectorData(key=f"e{i:02d}",
                                  vector=rng.standard_normal(8),
                                  metadata={"i": str(i)}))
    seen = []
    cursor = 0
    while cursor >= 0:
        r = svc.handle("export", {"cursor": cursor, "limit": 10})
        assert r["success"]
        seen.extend(rec["key"] for rec in r["records"])
        cursor = r["cursor"]
    assert sorted(seen) == [f"e{i:02d}" for i in range(25)]
    assert len(seen) == len(set(seen))
    svc.close()


def _fill(runner, which_cli, base, rng, n=15):
    vec = {}
    for i in range(n):
        v = rng.standard_normal(8).astype(np.float32)
        vec[f"x{i}"] = v
        arg = ",".join(f"{x:.6f}" for x in v)
        r = runner.invoke(which_cli, base + ["put", "-m", f"i={i}", "--",
                                             f"x{i}", arg])
        assert r.exit_code == 0, r.output
    return vec


def _read_dump(path):
    with open(path, "rb") as f:
        return {rec["key"]: rec for rec in msgpack.Unpacker(
            f, raw=False, ext_hook=jax_wire._ext_hook)}


def test_cli_export_import_roundtrip(tmp_path, rng):
    runner = CliRunner()
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    dump = str(tmp_path / "dump.msgpack")
    _fill(runner, cli, CPU + ["--data-dir", src], rng)
    r = runner.invoke(cli, CPU + ["--data-dir", src, "export", dump])
    assert r.exit_code == 0 and "exported 15" in r.output
    r = runner.invoke(cli, CPU + ["--data-dir", dst, "import", dump])
    assert r.exit_code == 0 and "imported 15" in r.output
    r = runner.invoke(cli, CPU + ["--data-dir", dst, "get", "x7"])
    assert r.exit_code == 0 and "'i': '7'" in r.output.replace('"', "'")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_backups_load_across_packages(direction, tmp_path, rng):
    """Export with one package's CLI, import with the other's, export
    again: the two dumps hold the same keys, vectors (bit for bit),
    metadata and timestamps."""
    runner = CliRunner()
    first, second = ((jax_cli, []), (cli, CPU)) \
        if direction == "jax_to_port" else ((cli, CPU), (jax_cli, []))
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    dump1, dump2 = str(tmp_path / "a.msgpack"), str(tmp_path / "b.msgpack")
    vec = _fill(runner, first[0], first[1] + ["--data-dir", src], rng)
    r = runner.invoke(first[0], first[1] + ["--data-dir", src, "export",
                                            dump1])
    assert r.exit_code == 0 and "exported 15" in r.output, r.output
    r = runner.invoke(second[0], second[1] + ["--data-dir", dst, "import",
                                              dump1])
    assert r.exit_code == 0 and "imported 15" in r.output, r.output
    r = runner.invoke(second[0], second[1] + ["--data-dir", dst, "export",
                                              dump2])
    assert r.exit_code == 0 and "exported 15" in r.output, r.output
    a, b = _read_dump(dump1), _read_dump(dump2)
    assert sorted(a) == sorted(b) == sorted(vec)
    for key in a:
        va = np.asarray(a[key]["vector"], np.float32)
        np.testing.assert_array_equal(va, np.asarray(b[key]["vector"],
                                                     np.float32))
        np.testing.assert_allclose(va, vec[key], atol=1e-6)
        assert a[key]["metadata"] == b[key]["metadata"]
        assert a[key]["timestamp"] == b[key]["timestamp"]

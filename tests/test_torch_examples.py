"""The port's examples (tpuvdb_torch/examples/) against the reference's
(examples/quickstart.py, examples/sharded_serving.py), on the CPU.

Each reference example is loaded from its path and its `main()` run with
tmp_path as the working directory (quickstart writes ./quickstart_db),
beside the port's `quickstart.main(device="cpu")` and
`sharded_serving.main(devices=["cpu"] * 4)`. The reference's
sharded_serving meshes the 8 virtual CPU devices of tests/conftest.py
(2 replicas x 4 shards), the port's 4 CPU slots (2 x 2). Shapes are the
examples' own: 10,000 x 512 f32 unit rows in 4 shards; 50,000 x 128
bf16 rows.

Compared: quickstart's `count:` lines equal, its first key equal (the
query is row 1234 plus 0.01 noise), its filtered results equal, and its
top-5 equal but for at most one key: with 4 shards the port's "approx" is
the 512-bucket scan, where rows of one slot share a bucket, and JAX's
approx_max_k is exact on the CPU. sharded_serving: self-retrieval 64/64
in both. The JAX package's native library is switched off, so no test
waits on its build.
"""

import contextlib
import importlib.util
import io
import os
import re

import pytest

import tpuvdb.native as jax_native
from tpuvdb_torch.examples import quickstart, sharded_serving

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stdout(fn, *args, **kw) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kw)
    return out.getvalue()


def _reference(name: str):
    spec = importlib.util.spec_from_file_location(
        f"ref_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        mp.setattr(jax_native, "rescore_available", lambda: False)
        for side in ("reference", "port"):
            mp.chdir(tmp_path_factory.mktemp(side))
            if side == "reference":
                out[side] = {name: _stdout(_reference(name).main)
                             for name in ("quickstart", "sharded_serving")}
            else:
                out[side] = {
                    "quickstart": _stdout(quickstart.main, device="cpu"),
                    "sharded_serving": _stdout(sharded_serving.main,
                                               devices=["cpu"] * 4)}
            assert os.path.isdir("quickstart_db")
    return out


def _hits(text: str) -> list:
    return re.findall(r"^  (img_\d{5}\.jpg)  d²=", text, re.M)


def _line(text: str, prefix: str) -> str:
    (line,) = [x for x in text.splitlines() if x.startswith(prefix)]
    return line


def test_quickstart_counts_and_filter(outputs):
    want, got = (outputs[s]["quickstart"] for s in ("reference", "port"))
    assert _line(got, "count:") == _line(want, "count:") == "count: 9999"
    assert _line(got, "filtered:") == _line(want, "filtered:")
    assert _line(got, "ingest:") == _line(want, "ingest:")


def test_quickstart_top5(outputs):
    want, got = (_hits(outputs[s]["quickstart"])
                 for s in ("reference", "port"))
    assert len(want) == len(got) == 5
    assert got[0] == want[0] == "img_01234.jpg"
    assert len(set(got) - set(want)) <= 1


def test_sharded_serving_self_retrieval(outputs):
    for side, mesh in (("reference", "2 replicas x 4 shards"),
                       ("port", "2 replicas x 2 shards")):
        text = outputs[side]["sharded_serving"]
        assert f"mesh: {mesh}" in text
        assert "self-retrieval: 64/64" in text
        assert _line(text, "single query:").startswith(
            "single query: ['v7'")

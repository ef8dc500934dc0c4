"""The port's binary wire codec (tpuvdb_torch/core/wire.py) against the
JAX package's (tpuvdb/core/wire.py).

Mirrors tests/test_wire.py (round trips, compactness, the JSON fallback of
ndarray-bearing responses) and adds the interchange: a frame encoded by
either package decodes in the other to the same object, and both encode
the same bytes.
"""

import json

import numpy as np
import pytest

from tpuvdb.core import wire as jax_wire
from tpuvdb_torch.core import wire


def _sample():
    return {
        "success": True,
        "records": [
            {"key": "a", "vector": np.arange(8, dtype=np.float32),
             "metadata": {"x": "1"}, "timestamp": 5},
        ],
        "cursor": -1,
        "nested": {"vectors": [[1.0, 2.0], [3.0, 4.0]]},
        "query_vector": [0.5, -1.25, 3.0],
        "ints": np.arange(4, dtype=np.int64),
    }


def test_roundtrip_nested():
    out = wire.decode(wire.encode(_sample()))
    assert out["success"] is True
    np.testing.assert_array_equal(out["records"][0]["vector"],
                                  np.arange(8, dtype=np.float32))
    assert out["records"][0]["vector"].dtype == np.float32
    # float-list fields compactified to f32 arrays
    np.testing.assert_allclose(out["nested"]["vectors"],
                               [[1.0, 2.0], [3.0, 4.0]])
    assert out["cursor"] == -1


def test_float_list_fields_compactified():
    vals = np.random.default_rng(0).standard_normal(768).tolist()
    enc = wire.encode({"vector": vals})
    # raw f32 payload: ~4 bytes/float + framing, far below JSON text
    assert len(enc) < 768 * 5
    assert len(enc) < len(json.dumps({"vector": vals})) / 4
    out = wire.decode(enc)
    assert isinstance(out["vector"], np.ndarray)
    assert out["vector"].dtype == np.float32


def test_ragged_vectors_survive():
    out = wire.decode(wire.encode({"vectors": [[1.0, 2.0], [3.0]]}))
    assert len(out["vectors"]) == 2
    np.testing.assert_allclose(out["vectors"][1], [3.0])


def test_json_default_handles_ndarray():
    from tpuvdb_torch.api.server import _json_default

    s = json.dumps({"vector": np.arange(3, dtype=np.float32)},
                   default=_json_default)
    assert json.loads(s)["vector"] == [0.0, 1.0, 2.0]


def test_empty_and_scalar_payloads():
    assert wire.decode(wire.encode({})) == {}
    out = wire.decode(wire.encode({"n": np.int64(7), "f": np.float32(1.5)}))
    assert out["n"] == 7 and abs(out["f"] - 1.5) < 1e-6


def _assert_same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_frames_decode_across_packages(direction):
    enc, dec = ((jax_wire.encode, wire.decode) if direction == "jax_to_port"
                else (wire.encode, jax_wire.decode))
    own = (wire.decode if direction == "jax_to_port" else jax_wire.decode)
    frame = enc(_sample())
    _assert_same(dec(frame), own(frame))
    out = dec(frame)
    np.testing.assert_array_equal(out["query_vector"],
                                  np.float32([0.5, -1.25, 3.0]))
    assert out["ints"].dtype == np.int64


def test_both_packages_encode_the_same_bytes():
    rng = np.random.default_rng(3)
    obj = {"records": [{"key": f"k{i}", "vector": rng.standard_normal(16),
                        "metadata": {"i": str(i)}, "timestamp": i}
                       for i in range(5)],
           "query_vectors": rng.standard_normal((3, 16)).astype(np.float32),
           "top_k": 4}
    assert wire.encode(obj) == jax_wire.encode(obj)
    assert wire.BINARY_CTYPE == jax_wire.BINARY_CTYPE


def test_decoded_arrays_are_read_only_and_the_engine_copies_them():
    """np.frombuffer hands back read-only arrays: the port's engine copies
    them before torch.from_numpy, so a decoded query searches without a
    warning."""
    import warnings

    from tpuvdb_torch import DBConfig, VectorDBEngine

    q = wire.decode(wire.encode({"q": np.ones((2, 8), np.float32)}))["q"]
    assert not q.flags.writeable
    eng = VectorDBEngine(DBConfig(vector_dim=8, shard_count=2,
                                  shard_capacity=256, block_size=128),
                         device="cpu")
    eng.put_rows(["a", "b"], np.stack([np.ones(8), np.zeros(8)])
                 .astype(np.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, keys = eng.search_batch(q, 1)
    assert keys == [["a"], ["a"]]
    eng.close()


def test_server_binary_ctype_is_the_wire_one():
    from tpuvdb_torch.api import server

    assert server.BINARY_CTYPE == wire.BINARY_CTYPE

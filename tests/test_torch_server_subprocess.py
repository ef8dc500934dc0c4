"""Ops-level end to end for the port: `python -m tpuvdb_torch.api.cli
serve --device cpu` as a real subprocess, driven over HTTP, stopped with
SIGTERM.

Mirrors tests/test_server_subprocess.py (which runs `tpuvdb serve`): the
server answers /healthz, a put, a search and list_nodes, exits cleanly on
SIGTERM and leaves a final checkpoint. Adds: a reopen of the same data_dir
serves the acknowledged put, and `serve` without --device on a machine
without CUDA exits non-zero naming it (the port never falls back to the
CPU).
"""

import http.client
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpuvdb_torch.api.client import DBClient

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["TPUVDB_LOG_LEVEL"] = "DEBUG"
    env["TPUVDB_HTTP_LOG"] = "1"
    env["TPUVDB_VECTOR_DIM"] = "8"
    env["TPUVDB_SHARD_CAPACITY"] = "1024"
    env["PYTHONPATH"] = ROOT
    return env


def _serve(port, data_dir, *extra):
    return subprocess.Popen(
        [sys.executable, "-m", "tpuvdb_torch.api.cli", "serve",
         "--port", str(port), "--data-dir", data_dir, *extra],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)


def _wait_healthy(proc, port, timeout_s=120):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            out = proc.stdout.read().decode(errors="replace")
            pytest.fail(f"server died during startup (rc={proc.returncode}); "
                        f"output:\n{out[-4000:]}")
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=2)
            conn.request("GET", "/healthz")
            if conn.getresponse().status == 200:
                return
        except (OSError, http.client.HTTPException):
            pass
        time.sleep(0.2)
    proc.kill()
    out = proc.stdout.read().decode(errors="replace")
    pytest.fail(f"server never became healthy; output:\n{out[-4000:]}")


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)
        pytest.fail("server ignored SIGTERM")


def test_serve_subprocess_roundtrip(tmp_path, rng):
    data_dir = str(tmp_path / "db")
    v = rng.standard_normal(8).astype(np.float32)
    port = _free_port()
    proc = _serve(port, data_dir, "--device", "cpu")
    try:
        _wait_healthy(proc, port)
        client = DBClient(f"127.0.0.1:{port}", timeout=60)
        assert client.call("put", {"key": "sp", "vector": v.tolist()})[
            "success"]
        r = client.call("search", {"query_vector": v.tolist(), "top_k": 1})
        assert r["success"] and r["search_result"]["keys"] == ["sp"]
        r = client.call("list_nodes", {})
        assert r["success"] and r["nodes"]
        client.close()
    finally:
        rc = _stop(proc)
    assert rc == 0, proc.stdout.read().decode(errors="replace")[-4000:]
    # graceful shutdown wrote a final checkpoint (service.close in serve)
    ckpts = tmp_path / "db" / "checkpoints"
    assert ckpts.exists() and any(ckpts.iterdir())

    # the acknowledged put is back after a restart on the same data_dir
    port = _free_port()
    proc = _serve(port, data_dir, "--device", "cpu")
    try:
        _wait_healthy(proc, port)
        client = DBClient(f"127.0.0.1:{port}", timeout=60)
        r = client.call("get", {"key": "sp"})
        assert r["success"]
        np.testing.assert_array_equal(
            np.asarray(r["vector_data"]["vector"], np.float32), v)
        client.close()
    finally:
        assert _stop(proc) == 0


def test_serve_without_cuda_exits_naming_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    res = subprocess.run(
        [sys.executable, "-m", "tpuvdb_torch.api.cli", "serve", "--port",
         str(_free_port()), "--data-dir", str(tmp_path / "db")],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stdout + res.stderr

"""The port's ops scripts (tpuvdb_torch/scripts/*.sh) against the
reference's (scripts/*.sh), run unedited, on the CPU.

* `start_cluster.sh demo` of each package on its own free ports and
  cluster dir: the port's with TPUVDB_DEVICE=cpu, the reference's with
  TPUVDB_PLATFORM=cpu (its default), started side by side (the reference's
  ~22 CLI processes each import JAX: about 90 s on the CPU). Each exits 0,
  prints FAILOVER OK, and answers `search -k 1` with key3 before and after
  node0 is killed. The two packages' answers name the same key, with
  distances within 1e-5 of |q|^2 + |x|^2, the terms that cancel in
  |q|^2 - 2 q.x + |x|^2 (one f32 ulp at |q|^2 ~ 512 is 6.1e-5; the
  distance printed is 0 up to that rounding).
* No port script names the JAX package's CLI; each runs the port's, with
  the device passed explicitly and cuda by default.
* One node through start_server.sh / register_node.sh / stop_server.sh:
  it answers /healthz, takes a registration, lists it, refuses a cluster
  start on its port (port_free), and stops with its pidfile gone.
"""

import os
import random
import re
import socket
import subprocess
import sys
import urllib.request

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SCRIPTS = os.path.join(ROOT, "tpuvdb_torch", "scripts")
SCRIPT_NAMES = ("start_server.sh", "stop_server.sh", "register_node.sh",
                "start_cluster.sh")
# "1    | key3 | -0.000061   | {}" of `search -k 1`
_TOP1 = re.compile(r"^1\s*\|\s*(\S+)\s*\|\s*(-?[0-9.]+)\s*\|", re.M)
DEMO_TIMEOUT = 400


def _free_block(n: int) -> int:
    """The first of n consecutive free localhost ports."""
    for _ in range(200):
        base = random.randint(20000, 60000 - n)
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                s.bind(("127.0.0.1", p))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port block")


def _env(**kw) -> dict:
    env = {**os.environ, "PYTHONPATH": ROOT, "TPUVDB_PYTHON": sys.executable,
           "JAX_PLATFORMS": "cpu"}
    env.update({k: str(v) for k, v in kw.items()})
    return env


def _demo(script: str, cluster_dir, **env) -> subprocess.Popen:
    base = _free_block(5)
    return subprocess.Popen(
        ["bash", script, "demo"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=_env(TPUVDB_CLUSTER_DIR=cluster_dir, TPUVDB_COORD_PORT=base,
                 TPUVDB_NODE_BASE_PORT=base + 1, **env))


def _finish(proc: subprocess.Popen) -> tuple:
    try:
        out, _ = proc.communicate(timeout=DEMO_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
    return proc.returncode, out


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
    """Both demos, run side by side: {package: (rc, output)}."""
    ref = _demo(os.path.join(ROOT, "scripts", "start_cluster.sh"),
                tmp_path_factory.mktemp("ref_cluster"),
                TPUVDB_PLATFORM="cpu")
    port = _demo(os.path.join(PORT_SCRIPTS, "start_cluster.sh"),
                 tmp_path_factory.mktemp("port_cluster"),
                 TPUVDB_DEVICE="cpu")
    return {"port": _finish(port), "reference": _finish(ref)}


def _query_sq() -> float:
    """|q|^2 of the demo's query: its seed-3 vector at 4 decimals."""
    random.seed(3)
    return sum(float(f"{random.gauss(0, 1):.4f}") ** 2 for _ in range(512))


@pytest.mark.parametrize("package", ["port", "reference"])
def test_demo_fails_over(demos, package):
    rc, out = demos[package]
    assert rc == 0, out[-3000:]
    assert "FAILOVER OK: all 8 keys served with node0 dead" in out
    top1 = _TOP1.findall(out)
    assert [key for key, _ in top1] == ["key3", "key3"], out[-3000:]
    assert "cluster stopped" in out


def test_demo_answers_equal_the_references(demos):
    got = _TOP1.findall(demos["port"][1])
    want = _TOP1.findall(demos["reference"][1])
    assert [k for k, _ in got] == [k for k, _ in want]
    tol = 1e-5 * 2 * _query_sq()  # |q|^2 + |x|^2, x = q
    for (_, d_got), (_, d_want) in zip(got, want):
        assert abs(float(d_got) - float(d_want)) <= tol, (d_got, d_want)


@pytest.mark.parametrize("name", SCRIPT_NAMES)
def test_scripts_run_the_ports_cli(name):
    with open(os.path.join(PORT_SCRIPTS, name)) as f:
        text = f.read()
    assert "tpuvdb.api.cli" not in text
    assert "TPUVDB_PLATFORM" not in text
    if name != "stop_server.sh":
        assert "-m tpuvdb_torch.api.cli" in text
    if name in ("start_server.sh", "start_cluster.sh"):
        assert 'DEVICE="${TPUVDB_DEVICE:-cuda}"' in text
        assert '--device "$DEVICE"' in text


def _run(name: str, *args, **env) -> subprocess.CompletedProcess:
    return subprocess.run(["bash", os.path.join(PORT_SCRIPTS, name), *args],
                          cwd=ROOT, env=_env(**env), capture_output=True,
                          text=True, timeout=120)


def test_one_node_starts_registers_and_stops(tmp_path):
    port = _free_block(2)
    run_dir = tmp_path / "run"
    env = dict(TPUVDB_PORT=port, TPUVDB_RUN_DIR=run_dir,
               TPUVDB_DATA_DIR=tmp_path / "data", TPUVDB_DEVICE="cpu",
               TPUVDB_COORD=f"127.0.0.1:{port}")
    started = _run("start_server.sh", **env)
    try:
        assert started.returncode == 0, started.stdout + started.stderr
        assert f"serving on http://127.0.0.1:{port}" in started.stdout
        pid = int((run_dir / "server.pid").read_text())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            assert r.status == 200
        # a second start finds the live pid and leaves it
        again = _run("start_server.sh", **env)
        assert again.returncode == 0 and "already running" in again.stdout
        reg = _run("register_node.sh", "nodeX", f"127.0.0.1:{port + 1}",
                   **env)
        assert reg.returncode == 0, reg.stdout + reg.stderr
        listed = subprocess.run(
            [sys.executable, "-m", "tpuvdb_torch.api.cli", "--coord-addr",
             f"127.0.0.1:{port}", "list-nodes"], cwd=ROOT, env=_env(),
            capture_output=True, text=True, timeout=60)
        assert listed.returncode == 0 and "nodeX" in listed.stdout
        # a cluster on a port already serving is refused (port_free)
        stale = _run("start_cluster.sh", "1", TPUVDB_COORD_PORT=port,
                     TPUVDB_CLUSTER_DIR=tmp_path / "cluster",
                     TPUVDB_DEVICE="cpu")
        assert stale.returncode == 1
        assert f"port {port} already serving" in stale.stderr
    finally:
        stopped = _run("stop_server.sh", **env)
    assert stopped.returncode == 0 and f"stopped pid {pid}" in stopped.stdout
    assert not (run_dir / "server.pid").exists()
    with pytest.raises(OSError):
        os.kill(pid, 0)

"""Runs one cell once:

  python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> \
      --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
The last line of stdout is the result (perfbench/harness.py); the last
lines of stderr are the compared numbers beside their limits. Exits 2,
printing no result, without CUDA or with too few cards, and 3 if a module
of JAX or of the JAX package was loaded.
"""

import time

_PERF_AT_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, ".perfbench_cache")


def process_start() -> float:
    """The process's start on the perf_counter clock (its age from
    /proc/self/stat against /proc/uptime; the first line of this module
    where those are missing)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return _PERF_AT_IMPORT


def set_caches() -> None:
    """Every kernel cache at a fixed path inside the checkout, so only a
    checkout's first run builds (the program's nvcc and g++ builds already
    go to tpuvdb_torch/build/)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_caches()

    import torch

    from perfbench.registry import Registry

    reg = Registry()
    chips = int(reg.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    from perfbench.harness import run_cell
    from perfbench.isolation import forbidden_loaded

    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", registry=reg,
                      t_start=t_start)
    found = forbidden_loaded()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

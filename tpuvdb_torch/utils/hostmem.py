"""Host-memory tuning and phase-boundary memory tracing: the port's copy of
tpuvdb.utils.hostmem.

Some virtualized hosts back guest RAM on demand: the first touch of
anonymous memory is slow while warm pages run at full speed. glibc munmaps
large (> 128 KB) blocks on free, so a loop that allocates a fresh
multi-hundred-MB numpy array per iteration faults its whole footprint in
again every time. keep_malloc_warm() raises the mmap threshold and
disables trimming so large equal-sized allocations recycle warm heap
pages; trim_heap() hands the freed pages back at a phase boundary. Both are
process-wide policy: call them from entry points, never at import.

One divergence by design: MEM_STAGES keeps the newest 4,096 samples. The
reference's list grows by six samples per IVF build for the life of the
process.
"""

from __future__ import annotations

import collections
import ctypes
import logging
import os

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3


def keep_malloc_warm(threshold: int = 1 << 30) -> bool:
    """Keep blocks under `threshold` bytes on the (reused) heap and never
    trim. Returns True when mallopt was applied, False on non-glibc."""
    try:
        libc = ctypes.CDLL(None)
        ok1 = libc.mallopt(_M_MMAP_THRESHOLD, threshold)
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, threshold)
        return bool(ok1 and ok2)
    except (OSError, AttributeError):
        return False


def trim_heap() -> bool:
    """Return freed heap pages to the OS (malloc_trim): a build phase
    reuses warm pages freely, then trims at its boundary so anonymous RSS
    tracks live data, not the phase's transient high-water."""
    try:
        libc = ctypes.CDLL(None)
        return bool(libc.malloc_trim(0))
    except (OSError, AttributeError):
        return False


#: where anon_gb() reads, in order: the rollup's `Anonymous:` line, then
#: the status file's `RssAnon:` (kernels or containers without the rollup)
ANON_SOURCES = (("/proc/self/smaps_rollup", "Anonymous:"),
                ("/proc/self/status", "RssAnon:"))


def anon_gb(sources=ANON_SOURCES) -> float:
    """Anonymous (non-file-backed) RSS in GB; -1 where no source reads."""
    for path, field in sources:
        try:
            with open(path) as f:
                for line in f:
                    if line.startswith(field):
                        return int(line.split()[1]) / 1024 / 1024
        except OSError:
            continue
    return -1.0


#: phase-boundary (tag, anon_gb) samples, appended by memlog() whether or
#: not TPUVDB_MEMLOG logging is on; the newest 4,096 are kept
MEM_STAGES: collections.deque = collections.deque(maxlen=4096)


def memlog(tag: str) -> None:
    """Phase-boundary memory tracer: records anonymous RSS per stage
    (always) and logs it when TPUVDB_MEMLOG is set, so a build's memory
    regression names its phase."""
    gb = anon_gb()
    MEM_STAGES.append((tag, round(gb, 2)))
    if os.environ.get("TPUVDB_MEMLOG"):
        logging.getLogger("tpuvdb_torch.memlog").warning(
            "[mem] %-32s anon %6.2f GB", tag, gb)

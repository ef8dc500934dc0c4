"""Session set-up shared by every test directory.

The JAX package's native library (`tpuvdb/native`) builds on first use
into one shared temporary file, so xdist workers that load it side by
side race there, and a worker that loses the race runs all its tests
without it: the native tests skip, and an engine whose two rescore paths
then take two numpy forms rounds them apart. The controlling process
builds it once here, before any worker starts; a worker then finds it
built and loads it. Loading imports no JAX. Where g++ is missing the
library stays unbuilt, as it would without this hook.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker
        return
    try:
        from tpuvdb import native
    except ImportError:  # a checkout without the JAX package
        return
    native.available()

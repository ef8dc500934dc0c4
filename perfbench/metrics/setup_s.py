"""Seconds from the process's start to the start of the window's first
call: interpreter, imports, the corpus, the bulk load and the index build,
the kernels' first load (and build, in a fresh checkout), the warm-up."""


def read(run):
    return run.setup_s

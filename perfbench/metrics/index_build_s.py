"""The engine's `index.build` stage: the device index built in set-up's
flush; its children are the flat index's upload (`build.upload`) or IVF's
`build.train`, `build.assign`, `build.split`, `build.pack` and
`build.upload` (index/exact.py, index/ivf.py), in s."""

from perfbench.spans import stage_s

CHILDREN = ["build.train", "build.assign", "build.split", "build.pack",
            "build.upload"]


def read(run):
    return stage_s(run, "index.build", CHILDREN)

"""Device selection and float32 precision for the port.

`device=None` means "cuda" everywhere in the package. Without CUDA that
raises: the port never carries on silently on the CPU. Tests and other
CPU callers pass `device="cpu"` explicitly.

f32 corpora score in full f32, as `Precision.HIGHEST` does in the
reference (tpuvdb/kernels/distance.py:38-44), so TF32 is switched off for
both matmuls and cuDNN when this module is imported.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`None` -> cuda; raise if the resolved device is CUDA and CUDA is
    not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; tpuvdb_torch runs on the GPU unless "
            "device='cpu' is passed explicitly")
    return dev

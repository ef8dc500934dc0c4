"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, no
sparsity, at its 700 W limit), which every roofline share divides by.

A share is stated against these whatever route a kernel takes: an f32
product counts against the TF32 tensor-core rate, the fastest at which the
card multiplies f32 inputs, so a kernel that moved from 3xTF32 to another
route is held to the same yardstick.
"""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {
    "float32": 495e12,   # TF32 tensor cores
    "bfloat16": 989e12,
    "int8": 1979e12,
}
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def bound_s(ops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate for `dtype` inputs and bytes over the memory's rate."""
    return max(ops / OPS_PER_S[dtype], nbytes / HBM_BYTES_PER_S)


def roofline_share(run, kernel: str):
    """Percent of the traced kernels' time that the card's bound takes for
    the work `roofline/<kernel>.py` counts; None where the trace holds no
    kernel of it. Prints the launches the trace shows beside the calls."""
    if run.trace is None:
        return None
    mod = run.registry.roofline(kernel)
    seconds = run.trace.seconds(mod.KERNELS)
    if seconds <= 0:
        return None
    work = mod.launches(run)
    bound = sum(bound_s(ops, nbytes, run.storage_dtype)
                for ops, nbytes in work)
    run.log(f"roofline {kernel}: {len(work)} calls, "
            f"{run.trace.launches(mod.MAIN)} {mod.MAIN} launches, kernels "
            f"{seconds:.6f} s, bound {bound:.6f} s, power limit "
            f"{run.power_limit}")
    return 100.0 * bound / seconds

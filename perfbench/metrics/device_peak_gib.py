"""The most device memory the process held at once over set-up, warm-up
and window (`torch.cuda.max_memory_allocated`), read when the window has
closed and before the reference does any work, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30

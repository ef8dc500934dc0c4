"""The index's device bytes (`info()["device_bytes"]`: the rows, norms and
validity, and for IVF the centroids and spill), in GiB."""


def read(run):
    return run.info["device_bytes"] / 2 ** 30

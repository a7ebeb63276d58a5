"""NCCL kernel milliseconds per training step on rank 0's card in the
profiled stretch: the gradient mean, the global BatchNorm's statistics and
the metrics' all-reduces."""


def read(reading):
    if reading.get("kind") != "train" or not reading.get("steps") \
            or not reading.get("nccl_s"):
        return None
    return 1e3 * reading["nccl_s"] / reading["steps"]

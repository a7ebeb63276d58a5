"""Requests per dispatch over the window, by ``serve.ServiceStats``' rows
and dispatches."""


def read(reading):
    if reading.get("kind") != "serve":
        return None
    return reading.get("mean_batch")

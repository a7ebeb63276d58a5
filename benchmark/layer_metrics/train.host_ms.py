"""Milliseconds per training step that the host spends inside the
program's ``train.step`` span (issuing the forward, the backward, the
gradient mean, the update and the metrics), the mean over a stretch run
with the span recorder on and nothing profiled
(``benchmark/trace/spans.py``).  Nothing from a program without the
recorder."""

from benchmark.trace import spans


def read(reading):
    r = spans.readings(reading)
    return r.get("host_ms") if r else None

"""Synchronizing CUDA calls per training step inside the program's
``train.step`` span (the counter ``sync`` of the span recorder, the loss
read after the step not counted), over a stretch run with the recorder on
and nothing profiled (``benchmark/trace/spans.py``).  Nothing without a
card, or from a program without the recorder."""

from benchmark.trace import spans


def read(reading):
    r = spans.readings(reading)
    return r.get("syncs") if r else None

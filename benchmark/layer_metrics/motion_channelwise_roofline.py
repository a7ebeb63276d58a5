"""X3D's channelwise convolutions' share of their roofline: the least time
their bytes per AV step take at 3.35 TB/s (forward, input gradient and
weight gradient, each activation once: ``counts.x3d.channelwise`` for the
clips ``motion.clips`` counted) over ``motion_channelwise.device_ms``,
whose span holds each convolution's BatchNorm too; an eager stretch of AV
steps profiled with the span recorder on (``benchmark/trace/x3d.py``).
Nothing without a card, in a cell whose motion net is no X3D, or from a
program without the span."""

from benchmark.trace import x3d


def read(reading):
    r = x3d.readings(reading)
    return r.get("roofline") if r else None

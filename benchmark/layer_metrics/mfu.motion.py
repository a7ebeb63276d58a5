"""The motion net's share of the card's peak in the configuration's dtype:
its trained FLOPs per AV step (``counts.flops.resnet3d_fast`` per clip,
the stem without an input gradient, times the ``motion.clips`` the
program counted per AV step) over ``motion.device_ms``
(``benchmark/trace/motion.py``).  Nothing where that reads nothing."""

from benchmark.trace import motion


def read(reading):
    r = motion.readings(reading)
    return r.get("mfu") if r else None

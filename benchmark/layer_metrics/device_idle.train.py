"""Share of an unprofiled training step in which no kernel ran on the
card: the card's busy time per step (the union of its activity intervals,
averaged over the cell's cards) in a stretch that traces the card's
activity alone, against the wall of a step in the unprofiled window.

The busy time is the card's own and does not grow under the profiler;
the wall is read where nothing is profiled, since even tracing the card's
activity alone slows the host's launch loop of a bfloat16 step by a third
or more.  The run prints the traced step beside the unprofiled one."""


def read(reading):
    if reading.get("kind") != "train" or not reading.get("steps") \
            or not reading.get("step_s"):
        return None
    return 100.0 * (1.0 - reading["busy_s"] / reading["steps"]
                    / reading["step_s"])

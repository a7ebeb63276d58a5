"""``frame_window``'s share of its roofline in the profiled training
stretch: the least time its launches' bytes take at 3.35 TB/s
(``benchmark/counts/bytes.py``; two launches per step, the mixture's B rows
and the sources' B x N) over the time the trace gives them.  Nothing when
the trace holds no launch, or not every launch the wrapper counted."""


def read(reading):
    if reading.get("kind") != "train":
        return None
    n = reading.get("frame_window_launches", 0)
    if not n or n != reading.get("frame_window_counted") \
            or not reading.get("frame_window_s"):
        return None
    return 100.0 * reading["frame_window_bound_s"] / reading["frame_window_s"]

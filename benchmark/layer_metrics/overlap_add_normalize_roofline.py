"""``overlap_add_normalize``'s share of its roofline in the profiled
serving stretch: the least time its launches' bytes take at 3.35 TB/s
(``benchmark/counts/bytes.py``; one launch per dispatch, ``max_batch`` x N
rows) over the time the trace gives them.  Nothing when the trace holds no
launch, or not every launch the wrapper counted."""


def read(reading):
    if reading.get("kind") != "serve":
        return None
    n = reading.get("overlap_add_launches", 0)
    if not n or n != reading.get("overlap_add_counted") \
            or not reading.get("overlap_add_s"):
        return None
    return 100.0 * reading["overlap_add_bound_s"] / reading["overlap_add_s"]

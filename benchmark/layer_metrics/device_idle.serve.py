"""Share of the profiled serving stretch (the open-loop load at the cell's
rate) in which no kernel ran on the card."""


def read(reading):
    if reading.get("kind") != "serve" or not reading.get("window_s"):
        return None
    return 100.0 * (1.0 - reading["busy_s"] / reading["window_s"])

"""Milliseconds per training step in which the card was busy (the union
of its activity intervals), over the steps of the stretch that traces
the card's activity alone."""


def read(reading):
    if reading.get("kind") != "train" or not reading.get("steps"):
        return None
    return 1e3 * reading["busy_s"] / reading["steps"]

"""The whole training step's share of the card's published peak: FLOPs
counted from the configuration's shapes (``benchmark/counts/flops.py``)
for the steps of the unprofiled window, over the window's seconds, over
the peak of the configuration's dtype times the cards."""


def read(reading):
    if reading.get("kind") != "train":
        return None
    return reading["mfu"]

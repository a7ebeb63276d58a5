"""The median dispatch of the window by ``serve.ServiceStats``: host clock
from a batch's copy to the card to its wavs on the host."""


def read(reading):
    if reading.get("kind") != "serve":
        return None
    return reading.get("dispatch_p50_ms")

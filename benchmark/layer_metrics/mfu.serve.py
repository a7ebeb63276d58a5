"""The dispatches' share of the card's float32 peak: the FLOPs of the
requests answered in the window (counted from the shapes, visual and
audio-only apart; padding rows count for nothing) over the summed dispatch
wall of ``serve.ServiceStats`` over 67 TFLOP/s."""


def read(reading):
    if reading.get("kind") != "serve":
        return None
    return reading.get("mfu")

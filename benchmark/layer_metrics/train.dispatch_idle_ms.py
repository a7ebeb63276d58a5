"""Milliseconds per training step in which the card was idle while the
host was inside the program's ``train.step`` span: every gap between the
card's merged busy intervals given to the innermost span open at its
middle, in a stretch run with the span recorder on and the card's
activity traced alone, the spans put on the trace's clock by anchors
(``benchmark/trace/spans.py``).  Nothing without a card, or from a program
without the recorder."""

from benchmark.trace import spans


def read(reading):
    r = spans.readings(reading)
    return r.get("dispatch_idle_ms") if r else None

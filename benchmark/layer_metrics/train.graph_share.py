"""Share of the training steps that ran as one replay of a CUDA graph: the
program's counter ``train.graph_replay`` over its ``train.step`` spans, in
the stretch run with the span recorder on and nothing profiled
(``benchmark/trace/spans.py``).  Nothing from a program without the
recorder, or without the graphed step (``train.GraphedStep``)."""

from benchmark.trace import spans


def _graphed_program() -> bool:
    try:
        from avsep_tpu_torch import train
    except ImportError:
        return False
    return hasattr(train, "GraphedStep")


def read(reading):
    r = spans.readings(reading)
    step = r.get("span_summary", {}).get("train.step") if r else None
    if not step or not step.get("count") or not _graphed_program():
        return None
    return step.get("train.graph_replay", 0) / step["count"]

"""What every cell of the benchmark shares: finding a cell's files by name,
seeds, the percentile rule, the check that the process never loaded JAX,
and the result line.

A cell of ``BENCHMARK.json`` names a configuration, a traffic mix and its
chips.  Its files are found by those names alone:

* ``benchmark/configs/<config>.json``: the model and its precision;
* ``benchmark/traffic/<traffic>.json``: the parameters of the mix, with
  ``driver`` naming the general generator under ``benchmark/drivers/``;
* ``benchmark/limits/<cell>.json``: the limits of the numbers compared to
  decide ``correct``, each with the readings it was set from;
* ``benchmark/layer_metrics/<metric>.py``: one reader per per-layer metric.

A later change adds a configuration, a mix, a cell or a metric by adding
such files and entries; none of this module's code names one.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(BENCH_DIR)
# everything a run writes stays inside the checkout, at fixed paths
OUT_DIR = os.path.join(REPO_DIR, "build", "benchmark")
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}
# top-level module names that must never be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "avsep_tpu")
# a request or a rank that takes longer has hung
WAIT_S = 120.0


def set_cache_env() -> None:
    """Point every build and kernel cache at a fixed directory inside the
    checkout, so only a checkout's first run builds, and keep libraries
    from loading JAX behind the program's back."""
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(REPO_DIR, "build", "bench_cache",
                                       sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``workloads`` with everything found by its names."""
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, spec: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of ``spec`` (``BENCHMARK.json`` by default) with
    its configuration, traffic, limits and the metrics it reports."""
    spec = spec or load_json(os.path.join(REPO_DIR, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; one of {sorted(cells)}")
    e2e, layers = spec["end_to_end"], spec["per_layer"]
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(os.path.join(REPO_DIR, conf["file"])),
        traffic=load_json(os.path.join(BENCH_DIR, "traffic",
                                       w["traffic"] + ".json")),
        limits=load_json(os.path.join(BENCH_DIR, "limits", name + ".json")),
        end_to_end=[m for m in e2e if _reports(m, name)],
        per_layer=[m for m in layers if _reports(m, name)])


def layer_reader(metric: str) -> Callable[[Any], Optional[float]]:
    """``read`` of ``benchmark/layer_metrics/<metric>.py`` (loaded by its
    path: a metric's name may hold dots)."""
    path = os.path.join(BENCH_DIR, "layer_metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.layer_metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sub_seed(seed: int, k: int) -> int:
    """A seed for the ``k``-th stream of a run, from any whole ``seed``."""
    return (int(seed) * 7919 + 104729 * (k + 1)) % (2 ** 63)


def percentile(sorted_values: List[float], p: float) -> float:
    """Element ``int(p * n)`` of a sorted list (the median is element
    ``n // 2``), the JAX tools' rule, frozen here."""
    return sorted_values[min(len(sorted_values) - 1,
                             int(p * len(sorted_values)))]


def forbidden_loaded() -> List[str]:
    """The modules of :data:`FORBIDDEN` in ``sys.modules``, compared by
    whole top-level name (``avsep_tpu_torch`` is not ``avsep_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in FORBIDDEN if t in tops)


@dataclass
class Check:
    """One number compared to decide ``correct``, beside its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back: the end-to-end values, what the per-layer
    readers read (``reading``), the checks, and the device."""
    attempted: int
    failed: int
    e2e: Dict[str, float]
    checks: List[Check]
    device: Dict[str, Any]
    reading: Dict[str, Any] = field(default_factory=dict)
    breakdown: Optional[Dict] = None

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) \
            and self.failed == 0


def result_line(cell: Cell, out: Outcome, trace: bool) -> Dict:
    """The result's JSON object: the cell's end-to-end metrics, or with
    ``trace`` its per-layer metrics (a reader that finds nothing leaves
    its metric out); the checks come last."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = layer_reader(m["name"])(out.reading)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(out.e2e[m["name"]]),
                                  "unit": m["unit"]}
    line = {"correct": out.correct, "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics,
            "device": out.device}
    if trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}
    return line


def check_lines(checks: List[Check]) -> List[str]:
    return [f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
            f"{'ok' if c.ok else 'FAILED'}" for c in checks]

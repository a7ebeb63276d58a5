"""Cells of the benchmark cut to a size a CPU test run holds: a 5-level
U-Net on 8191 samples, 64x64 frames, two rows and a short window.

Besides the cells of ``BENCHMARK.json`` the tests reach the cells kept
out of it, whose entries stand in ``benchmark/pending/<cell>.json``: the
workload, its own metrics, and the names of the benchmark's metrics it
would report too (``extends``), as a later benchmark adds them; and the
cells of :data:`VARIANTS`, built here alone: a cell of the benchmark with
some flags changed (``clipatt.train``: ``music.train`` whose visual
stream is a 4-frame video clip through the motion net).
"""

from __future__ import annotations

import copy
import dataclasses
import os

from benchmark import harness

SMALL = {"arch_sound": "unet5", "audLen": 8191, "imgSize": 64,
         "dtype": "float32"}
TRAFFIC = {"batch_per_card": 2, "pool_clips": 64, "trace_steps": 2,
           "check_requests": 4, "rate_per_s": 4.0, "max_batch": 2,
           "trace_seconds": 0.5, "warm_rounds": 2, "clients": 4}
# a test-only cell: (the cell it is built on, the flags it changes)
VARIANTS = {"clipatt.train": ("music.train", {
    "fusion_type": "CoLoc_ClipAtt", "load_clips": True, "clip_len": 4,
    "lr_motion": 1e-4})}
PENDING_DIR = os.path.join(harness.BENCH_DIR, "pending")
PENDING = sorted(f[:-5] for f in os.listdir(PENDING_DIR)
                 if f.endswith(".json"))


def spec_with(pending: str) -> dict:
    """``BENCHMARK.json`` with the entries of a pending cell added."""
    spec = harness.load_json(os.path.join(harness.REPO_DIR,
                                          "BENCHMARK.json"))
    p = harness.load_json(os.path.join(PENDING_DIR, pending + ".json"))
    for key in ("end_to_end", "per_layer"):
        for m in spec[key]:
            if m["name"] in p["extends"]:
                m["workloads"] = m.get("workloads", []) + [pending]
        spec[key] += p[key]
    spec["workloads"].append(p["workload"])
    return spec


def full(name: str) -> harness.Cell:
    """A cell at its own size, pending or not."""
    return harness.find_cell(
        name, spec_with(name) if name in PENDING else None)


def cell(name: str, **traffic) -> harness.Cell:
    base, flags = VARIANTS.get(name, (name, {}))
    c = dataclasses.replace(full(base), name=name)
    config = copy.deepcopy(c.config)
    config["flags"].update(SMALL, **flags)
    if "serve_flags" in config:
        config["serve_flags"] = dict(config["serve_flags"])
    t = dict(c.traffic)
    t.update({k: v for k, v in TRAFFIC.items() if k in t})
    t.update(traffic)
    return dataclasses.replace(c, config=config, traffic=t)

"""The serving cell's load sweep: the highest offered rate the service
sustains without a growing backlog, from which the cell's fixed rate is
set (four fifths of it).

    python3 -m benchmark.sweep --workload music.serve --rates 60,120,...
        [--seconds 10] [--seed n]

Each rate is one run of the cell's driver with only ``rate_per_s``
changed; a rate is sustained when the requests due in the window's last
quarter wait no longer at the 95th percentile than twice those of its
first quarter, and the last reply comes within a second of the close.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from benchmark import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=9_000_000_001)
    args = ap.parse_args(argv)
    harness.set_cache_env()
    from benchmark.drivers import serve
    cell = harness.find_cell(args.workload)
    for rate in [float(r) for r in args.rates.split(",")]:
        c = dataclasses.replace(cell, traffic={**cell.traffic,
                                               "rate_per_s": rate})
        out = serve.run(c, args.seed, args.seconds, False, None, time.time())
        first, last = out.reading["p95_first_last_quarter_ms"]
        ok = last <= 2 * first and \
            out.reading["last_done_s"] <= args.seconds + 1.0
        print(json.dumps({"rate_per_s": rate, "sustained": ok,
                          "p50_ms": out.e2e["serve_p50_ms"],
                          "p95_ms": out.e2e["serve_p95_ms"],
                          "p95_first_last_quarter_ms": [first, last],
                          "last_done_s": out.reading["last_done_s"],
                          "mean_batch": out.reading["mean_batch"],
                          "dispatch_p50_ms": out.reading["dispatch_p50_ms"],
                          "failed": out.failed,
                          "checks": {c.name: c.value for c in out.checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Find the highest arrival rate an open-loop cell sustains.

    python3 portbench/sweep.py --workload <cell> --seed <n> \
        --seconds <s> --rates <r,r,...>

runs the cell once at each rate (requests a second) in place of its
mix's ``rate_per_s``, and prints one JSON line a rate: the time to the
first token (median and 95th percentile over the window's requests),
the median of the first and of the last third of them, which part of
the requests due were served, and the output tokens a second.  A rate
is sustained while the last third waits no longer than the first: a
queue that grows shows as a last third that waits longer.  The cell's
mix then takes a fixed rate below the highest sustained one; the
benchmark never searches for a rate itself.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench.lib import cells, stats

    torch.set_num_threads(4)
    bench = cells.benchmark()
    for rate in [float(r) for r in args.rates.split(",")]:
        c = cells.cell(bench, args.workload, seed=args.seed,
                       seconds=args.seconds, t_start=time.monotonic())
        c.mix = dict(c.mix, rate_per_s=rate)
        rec = cells.drive(c)
        t0, t1 = rec["t0"], rec["t_end"]
        due = sorted((r for r in rec["requests"] if t0 <= r["due"] < t1),
                     key=lambda r: r["due"])
        ttft = [r["times"][0] - r["due"] if r["times"] else float("inf")
                for r in due]
        third = max(1, len(ttft) // 3)
        print(json.dumps({
            "rate_per_s": rate, "requests": len(due),
            "served": sum(1 for r in due if r["times"]),
            "ttft_p50_s": stats.percentile(ttft, 50),
            "ttft_p95_s": stats.percentile(ttft, 95),
            "ttft_first_third_median_s": statistics.median(ttft[:third]),
            "ttft_last_third_median_s": statistics.median(ttft[-third:]),
            "output_tokens_per_s": cells.reader("output_tokens_per_s")(rec),
            "itl_p95_ms": cells.reader("itl_p95_ms")(rec),
            "max_lag_s": rec["max_lag_s"],
            "correct": rec["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

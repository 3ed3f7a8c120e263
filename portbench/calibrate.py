"""The readings that the correctness limits are set from, in one process.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n,n,...> --control-seeds <n,n,n>

For each of ``--seeds`` it runs the cell as a benchmark run does (set-up,
a window of ``--seconds``, the check) and prints the numbers compared:
the program's readings, whose largest is a limit's lower end.  For each
of ``--control-seeds`` it reads the control too, the plain reference in
the program's place computed in float8 (for a served model, the
reference's gap of the token that float8 puts first at each position of
the same requests), and for a training cell the fault of half the batch
left out (the reference on the first half of each batch); their smallest
is a limit's upper end.  A run of this script is not a benchmark run:
it takes the time of a dozen runs and prints one JSON line a reading to
standard output and a summary last.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def _ints(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    args = ap.parse_args(argv)

    import torch

    from portbench.lib import cells, train_cell

    bench = cells.benchmark()
    torch.set_num_threads(4)
    rows = []

    def emit(row: dict) -> None:
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in args.seeds:
        c = cells.cell(bench, args.workload, seed=seed, seconds=args.seconds,
                       t_start=time.monotonic())
        kind = c.cfg["kind"]
        if kind == "serve" and seed in args.control_seeds:
            c.control = "fp8"
        rec = cells.drive(c)
        emit({"seed": seed, "side": "program",
              "numbers": {k: v["value"] for k, v in rec["checks"].items()},
              "setup_s": rec["setup_s"], "reference_s": rec["reference_s"],
              "tokens_compared": rec.get("tokens_compared"),
              "losses": rec.get("losses")})
        if "control_max_logit_gap" in rec:
            emit({"seed": seed, "side": "control_fp8",
                  "numbers": {"max_logit_gap": rec["control_max_logit_gap"]}})
    if cells.cell(bench, args.workload).cfg["kind"] == "train":
        for seed in args.control_seeds:
            c = cells.cell(bench, args.workload, seed=seed)
            dev = torch.device("cuda")
            want = train_cell.reference_run(c.cfg, seed, c.mix, dev)
            for side, kw in (("control_fp8", {"quant": "fp8"}),
                             ("fault_half_batch",
                              {"rows": int(c.mix["batch"]) // 2})):
                got = train_cell.reference_run(c.cfg, seed, c.mix, dev, **kw)
                emit({"seed": seed, "side": side,
                      "numbers": train_cell.compare(got, want),
                      "losses": got["losses"]})
                del got
            del want
            torch.cuda.empty_cache()
    summary = {}
    for row in rows:
        for k, v in row["numbers"].items():
            s = summary.setdefault(row["side"], {}).setdefault(k, [])
            s.append(v)
    print(json.dumps({"summary": {side: {k: {"min": min(v), "max": max(v),
                                             "n": len(v)}
                                         for k, v in d.items()}
                                  for side, d in summary.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``;
its configuration, traffic mix, limits and metric readers are files
under ``portbench/`` found by name (``lib/cells.py``).  The last line of
standard output is the result as one JSON object; the numbers that
decide ``correct`` are printed beside their limits as the last lines of
standard error and under ``checks`` in the result.

The run needs as many CUDA devices as the cell asks for, and exits with
code 2 and no result without them.  It exits with code 3 and no result
if JAX or the JAX package was loaded into this process.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not portbench/, heads the import path
sys.path[0] = ROOT
CACHE = os.path.join(ROOT, "portbench", ".cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, the part before the first
    dot, is JAX's or the JAX package's (``ray_tpu_torch`` is not
    ``ray_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.lib import cells

    bench = cells.benchmark()
    c = cells.cell(bench, args.workload, seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace),
                   t_start=T_START)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < c.chips:
        print(f"needs {c.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    record = cells.drive(c)
    out = cells.result(bench, c, record)
    bad = forbidden_modules()
    if bad:
        print(f"loaded forbidden modules: {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, chk in out["checks"].items():
        print(f"check {name} = {chk['value']!r} limit {chk['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

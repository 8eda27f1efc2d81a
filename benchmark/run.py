"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
Without them it prints why on standard error and exits 2; it never falls
back to the CPU.  The last line of standard output is the result, one JSON
object; the numbers that decide ``correct`` are the last lines of
standard error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import core

    line, code = core.run(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0,
                          root=ROOT, log=lambda msg: print(msg, file=sys.stderr, flush=True))
    if line is not None:
        print(json.dumps(line), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())

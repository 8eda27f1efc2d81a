"""The numbers that decide ``correct``, read over many seeds in one process,
for setting a cell's limits (PERF.md, "How correct is decided"):

* ``--control none``: sound runs of the program (one set-up per seed);
* ``--control tf32``: the program with TF32 matmuls on, the precision below
  the configurations' float32 with TF32 off;
* ``--control reference``: the plain reference put in the program's place
  with every product's operands rounded to TF32, judged against the
  float64 reference as the program is.  It runs no program.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 --seconds 10 [--control tf32]

Prints one JSON line per seed.  ``none`` and ``tf32`` need the card, as
``run.py`` does.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def reference_control(workload, seed, device, root=ROOT):
    """The readings of the plain reference put in the program's place with
    every product's operands rounded to TF32 (its H x, and the pairs of its
    own Lanczos run from solve 0's start vector), judged as the program's
    answers are."""
    import torch

    from benchmark import core, manifest

    cell = manifest.Cell(manifest.load(root), workload, root)
    kwargs = cell.traffic["kwargs"]
    ref = manifest.module("reference", cell.config["kind"]).build(cell.config, device)
    plain = manifest.module("reference", cell.traffic["reference"])
    starts = core.Starts(seed, ref.m, getattr(torch, cell.config["dtype"]), device)
    x = starts.draw(0, tag=core.OPCHECK).double()
    op_check = {"x": x, "y": ref.apply(x, control=True)}
    theta, Y, est = plain.solve(ref.apply, starts.draw(0).double(), kwargs, control=True)
    return core.judge(ref, plain, op_check, [(0, torch.as_tensor(theta), Y, est)], kwargs, ref.m,
                      lambda i: starts.draw(i).double())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", choices=("none", "tf32", "reference"), default="none")
    args = p.parse_args(argv)

    from benchmark import core

    code = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        head = {"workload": args.workload, "seed": seed, "control": args.control}
        if args.control == "reference":
            got = reference_control(args.workload, seed, "cuda")
            print(json.dumps({**head, "readings": got}), flush=True)
            continue
        try:
            line, rc = core.run(args.workload, seed, args.seconds, False, t0=time.perf_counter(),
                                root=ROOT, tf32=True if args.control == "tf32" else None,
                                log=lambda msg: print(msg, file=sys.stderr, flush=True))
        except Exception as exc:  # a control that crashes has failed: record it, go on
            print(json.dumps({**head, "error": repr(exc)}), flush=True)
            code = 1
            continue
        if line is None:
            return rc
        print(json.dumps({**head, "correct": line["correct"], "readings": line["readings"],
                          "metrics": line["metrics"]}), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())

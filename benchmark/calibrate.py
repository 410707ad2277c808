"""Readings of sound runs and of the control over many seeds, in one
process, for setting a cell's limits (``limits/<cell>.json``).

    python benchmark/calibrate.py --workload <cell> --seeds 1 2 3 \\
        --seconds 2 [--out cal.jsonl]

Each seed is one run of the cell's generator with a short window, then the
control: the plain reference put in the program's place and computed in
the precision below the configuration's (fp8 for the bf16 model, bf16 for
the float32 k-space chain), judged by the same comparison, and for a
training cell a fault planted in the reference put in the program's place
(half of each batch left out) and the float32 reference against itself
with its input moved by one bfloat16 step (the floor any lower-precision
step reads). One JSON line a seed: the program's readings, the control's,
the fault's and the floor's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(HERE.parent))

from benchmark import harness  # noqa: E402
from benchmark.run import run_cell  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibration reads the card; no CUDA card here",
              file=sys.stderr)
        return 2
    cell = harness.cell(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t = time.time()
        res = run_cell(cell, seed, args.seconds, False, dev, t, control=True)
        line = {"cell": args.workload, "seed": seed,
                "readings": res["readings"],
                "control": res["control_readings"],
                "faults": res.get("fault_readings", {}),
                "jitter": res.get("jitter_readings", {}),
                "e2e": res["e2e"], "counts": res["counts"],
                "seconds": time.time() - t}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

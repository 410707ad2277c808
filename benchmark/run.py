"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds the port. The run makes its inputs
and weights from ``--seed``, warms every shape it will use (set-up,
reported as ``setup_s``), measures for ``--seconds``, checks what the
timed path produced against the plain reference, and prints as the last
line of standard output (after a line with the card's name and power
limit, the peak GiB and what the window counted) one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``, then ``checks``,
each compared number beside its limit.
The same numbers close standard error. Without as many CUDA cards as the
cell asks for, or with JAX or the JAX package loaded, it prints no result
and exits with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the package is imported from the checkout's root, never from this
# folder, so that its subfolders shadow no installed module
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, dev,
             t_start: float, control: bool = False) -> dict:
    """The cell's traffic generator (``generators/<name>.py``, named by
    its traffic file) run once."""
    gen = importlib.import_module(
        f"benchmark.generators.{cell['traffic']['generator']}")
    return gen.run(cell, seed, seconds, trace, dev, t_start,
                      control=control)


def result_line(cell: dict, res: dict, trace: bool, kind: str) -> dict:
    from benchmark.reference.compare import held
    limits = cell["limits"]
    metrics = {}
    if trace:
        ctx = dict(res["ctx"], trace=res["trace"])
        for m in cell["per_layer"]:
            value = harness.read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(res["e2e"], setup_s=res["setup_s"])
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": bool(held(res["readings"], limits)
                            and res["failed"] == 0),
            "attempted": int(res["attempted"]), "failed": int(res["failed"]),
            "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = res["trace"]["busy_s"]
        device["window_s"] = res["trace"]["window_s"]
        line["breakdown"] = {"device_ops": res["trace"]["device_ops"],
                             "idle_gaps": res["trace"]["idle_gaps"]}
    line["checks"] = harness.checks_text(res["readings"], limits)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bad = harness.forbidden_modules()
    if bad:
        print(f"refusing to run: {bad} loaded at start-up", file=sys.stderr)
        return 3
    cell = harness.cell(args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(dev)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev,
                   T_START)
    line = result_line(cell, res, bool(args.trace), kind)
    bad = harness.forbidden_modules()
    if bad:
        print(f"refusing to report: {bad} loaded during the run",
              file=sys.stderr)
        return 3
    info = dict(harness.card(), cell=args.workload, seed=args.seed,
                trace=args.trace, setup_s=res["setup_s"],
                peak_gib=res["memory_peak_bytes"] / 2 ** 30, **res["counts"])
    print(json.dumps(info), flush=True)
    print(json.dumps(info), file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

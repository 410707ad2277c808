"""What every cell shares: finding a cell's files by name, the import
guard, the card's description, the per-layer readers and the result
line."""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Dict, Iterable, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that may not be loaded in a run: JAX and the JAX
# package the port was made from (compared whole: the port's own name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "mri_acl_imagesegmentation_adsp_tpu")


def forbidden_modules(names: Iterable[str] | None = None) -> List[str]:
    """The forbidden top-level names among ``names`` (by default the
    modules loaded in this process)."""
    names = sys.modules if names is None else names
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(tops.intersection(FORBIDDEN))


def sub_seed(seed: int, k: int) -> int:
    """The seed of the run's ``k``-th stream (weights, data, augmentation,
    order), distinct for every ``(seed, k)`` a run can be given."""
    return (int(seed) * 1_000_003 + k) % 2 ** 63


def generator(seed: int, k: int, device) -> "torch.Generator":
    import torch
    return torch.Generator(device=device).manual_seed(sub_seed(seed, k))


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def cell(workload: str, bench: dict | None = None) -> dict:
    """The cell ``workload`` of ``BENCHMARK.json`` with what it names: its
    configuration, traffic and limits, and the metrics it reports."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]

    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    return {"name": workload, "chips": w["chips"],
            "config": load_json(ROOT / cfg_entry["file"]),
            "traffic": load_json(HERE / "workloads"
                                 / f"{w['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{workload}.json"),
            "end_to_end": e2e, "per_layer": layer}


def metric_file(name: str) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, or else the
    reader of its family, ``metrics/<name up to its first dot>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    return path if path.exists() else HERE / "metrics" / (
        name.split(".", 1)[0] + ".py")


def read_metric(name: str, ctx: dict):
    """The reader's ``read(ctx)`` (:func:`metric_file`): a number, or
    ``None`` when the run has nothing for it to read."""
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def card() -> Dict[str, str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    return {"nvidia_smi": out[0] if out else "not read"}


def checks_text(readings: Dict[str, float], limits: Dict[str, float]
                ) -> Dict[str, dict]:
    """Each compared number beside its limit (a non-finite number as its
    name, which JSON has no number for)."""
    def num(v):
        return v if math.isfinite(v) else repr(v)
    return {k: {"value": num(readings[k]), "limit": limits[k]}
            for k in limits}

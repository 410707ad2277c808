"""The harness: cells found by name in files of their own, the result line,
the import guard and the trace reduction."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness, tracing
from benchmark.run import result_line, run_cell

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_and_reports(name):
    cell = harness.cell(name)
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in e2e
        assert harness.metric_file(m["name"]).exists()
    assert set(cell["limits"]) and all(v > 0 for v in cell["limits"].values())


def test_a_metric_family_shares_one_reader():
    """``device_idle_pct.<cells>`` reads through ``device_idle_pct.py``,
    so a new cell's idle metric needs no file of its own."""
    for name in ("device_idle_pct.train", "device_idle_pct.kspace",
                 "device_idle_pct.recon"):
        assert harness.metric_file(name).name == "device_idle_pct.py"
    assert harness.read_metric("device_idle_pct.recon", {
        "trace": {"busy_s": 3.0, "window_s": 4.0}}) == 25.0
    assert harness.read_metric("device_idle_pct.recon", {}) is None


def test_bench_file_follows_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def _tiny_train_cell(bench, root):
    """A new cell added as files only: a traffic file and a limits file
    in a copy of the benchmark's data folders, and its entry."""
    (root / "benchmark" / "workloads" / "train_b4_tiny.json").write_text(
        json.dumps({"generator": "train", "volumes": 2, "slices_per_volume": 8,
                    "batch": 4, "checked_steps": 3}))
    (root / "benchmark" / "limits" / "train.tiny.b4.json").write_text(
        json.dumps({"loss_gap_first": 1.0}))
    bench["workloads"].append({"name": "train.tiny.b4",
                               "config": "unet_r34_320",
                               "traffic": "train_b4_tiny", "chips": 1,
                               "why": "tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "train.unet_r34.b128" in m.get("workloads", []):
            m["workloads"].append("train.tiny.b4")


def test_a_cell_from_files_alone(tmp_path, monkeypatch):
    for sub in ("configs", "workloads", "limits", "metrics"):
        shutil.copytree(harness.HERE / sub, tmp_path / "benchmark" / sub)
    monkeypatch.setattr(harness, "HERE", tmp_path / "benchmark")
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    bench = json.loads(json.dumps(BENCH))
    _tiny_train_cell(bench, tmp_path)
    cell = harness.cell("train.tiny.b4", bench)
    cell["config"]["image_size"] = 64       # CPU-sized, same code path
    res = run_cell(cell, 2 ** 31 + 7, 0.1, True, torch.device("cpu"), 0.0)
    line = result_line(cell, res, True, "cpu")
    assert line["attempted"] == res["counts"]["steps"] > 0
    assert set(line["metrics"]) == {"step_mfu.train",
                                    "device_idle_pct.train"}
    assert list(line)[-1] == "checks"
    assert line["checks"]["loss_gap_first"]["limit"] == 1.0
    json.loads(json.dumps(line))
    e2e = result_line(cell, res, False, "cpu")["metrics"]
    assert set(e2e) == {"setup_s", "train_slices_per_s"}


def test_import_guard_compares_whole_names():
    assert harness.forbidden_modules(
        ["mri_acl_imagesegmentation_adsp_tpu_torch",
         "mri_acl_imagesegmentation_adsp_tpu_torch.models.unet2d",
         "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(
        ["mri_acl_imagesegmentation_adsp_tpu.models"]) == [
        "mri_acl_imagesegmentation_adsp_tpu"]
    assert harness.forbidden_modules(["jax.numpy", "flax.linen",
                                      "jaxlib"]) == ["flax", "jax", "jaxlib"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.run, benchmark.generators.train, "
            "benchmark.generators.kspace, benchmark.calibrate; "
            "import mri_acl_imagesegmentation_adsp_tpu_torch.cli.serve, "
            "mri_acl_imagesegmentation_adsp_tpu_torch.train.engine; "
            "from benchmark.harness import forbidden_modules; "
            "print(forbidden_modules())" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""


def test_trace_reduction():
    ms = 1_000_000
    dev = [("k1", 0, 2 * ms), ("k2", 1 * ms, 3 * ms), ("k1", 6 * ms,
                                                          7 * ms),
           ("k3", 9 * ms, 12 * ms)]
    host = [("bench::window", 0, 10 * ms), ("aten::copy_", 3 * ms, 6 * ms),
            ("cudaStreamSynchronize", 4 * ms, 5 * ms)]
    r = tracing.reduce_events(dev, host, (0, 10 * ms))
    assert r["window_s"] == pytest.approx(0.010)
    assert r["busy_s"] == pytest.approx(0.005)      # [0,3] [6,7] [9,10]
    # the innermost host range open at the gap's middle names it
    assert r["idle_gaps"][0] == ["cudaStreamSynchronize",
                                 pytest.approx(0.003)]
    assert r["idle_gaps"][1] == ["host (no range open)",
                                 pytest.approx(0.002)]
    assert r["device_ops"][0] == ["k1", pytest.approx(0.003)]

"""Parity of the PyTorch port's host remainder with the JAX package: the
config layer (``load_env``, the dataset-root globals, the YAML registry and
the launcher's default root), the JSON logger, ``cli.main``'s adapter
preview and preprocess stage, ``utils.smoke`` and the replay gate.

The fastMRI ``.h5`` files are written here by the port's copy of the test
oracle's generator (``utils/synthetic.py``), bit-equal to it. The replay
gate's launchers are replaced on both sides by a stand-in that records its
flags and writes the run's ``summary.json``, so nothing trains; the flags
must be equal. Everything else is compared for equality: the parsed
environment, the logger's JSON fields, the preview's text.
"""
import json
import logging
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import oracles
from mri_acl_imagesegmentation_adsp_tpu.cli import launcher as jlauncher
from mri_acl_imagesegmentation_adsp_tpu.cli import main as jmain
from mri_acl_imagesegmentation_adsp_tpu.cli import replay_gate as jgate
from mri_acl_imagesegmentation_adsp_tpu.configs import config as jconfig
from mri_acl_imagesegmentation_adsp_tpu.utils import logger as jlogger
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import launcher
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import main as tmain
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import replay_gate
from mri_acl_imagesegmentation_adsp_tpu_torch.configs import config, registry
from mri_acl_imagesegmentation_adsp_tpu_torch.models.unet2d import (
    ResNetEncoderUNet)
from mri_acl_imagesegmentation_adsp_tpu_torch.utils import logger, smoke
from mri_acl_imagesegmentation_adsp_tpu_torch.utils import synthetic

PORT = Path(__file__).resolve().parents[1] / \
    "mri_acl_imagesegmentation_adsp_tpu_torch"


def test_load_env_and_dataset_roots(tmp_path, monkeypatch, capsys):
    env = tmp_path / ".env"
    env.write_text("# roots\nFASTMRI_ROOT='/data/fastmri'\nOAI_ZIB_ROOT = "
                   "/data/oai\nnot a pair\n\nKNEE_MRI_ROOT=\"/k\"\n")
    for key in config.ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    ours = config.load_env(str(env))
    ours_env = {k: os.environ.pop(k) for k in ours}
    theirs = jconfig.load_env(str(env))
    assert ours == theirs and ours_env == {k: os.environ[k] for k in theirs}
    monkeypatch.setenv("OAI_ZIB_ROOT", "/elsewhere")
    assert config.load_env(str(env))["OAI_ZIB_ROOT"] == "/data/oai"
    assert os.environ["OAI_ZIB_ROOT"] == "/elsewhere"   # no override
    config.load_env(str(env), override=True)
    assert os.environ["OAI_ZIB_ROOT"] == "/data/oai"
    # the globals read the environment at each use, found by the CWD's .env
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(config, "_env_loaded", False)
    for key in config.ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    assert config.FASTMRI_ROOT == "/data/fastmri"
    assert "[WARN] SKM_TEA_MAIN_ROOT" in capsys.readouterr().out
    assert launcher.build_parser().parse_args([]).dataset_root == Path(
        "/data/fastmri")
    monkeypatch.setenv("FASTMRI_ROOT", "/moved")
    assert config.FASTMRI_ROOT == "/moved"
    monkeypatch.delenv("FASTMRI_ROOT")
    assert launcher.build_parser().parse_args([]).dataset_root is None
    with pytest.raises(AttributeError):
        config.NOT_A_ROOT


def test_load_env_stops_at_the_project_root(tmp_path, monkeypatch):
    """A ``.env`` above the project root is not read, one at the root is
    (from a directory inside it and from one outside), and only the five
    roots of it reach the environment."""
    proj = tmp_path / "proj"
    (proj / "sub").mkdir(parents=True)
    (tmp_path / "elsewhere").mkdir()
    (tmp_path / ".env").write_text("FASTMRI_ROOT=/above\n")
    monkeypatch.setattr(config, "PROJECT_ROOT", proj.resolve())
    for key in [*config.ENV_KEYS, "NOT_A_ROOT"]:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(proj / "sub")
    assert config.load_env() == {} and "FASTMRI_ROOT" not in os.environ
    (proj / ".env").write_text("FASTMRI_ROOT=/proj\nNOT_A_ROOT=1\n")
    for cwd in (proj / "sub", proj, tmp_path / "elsewhere"):
        monkeypatch.chdir(cwd)
        assert config.load_env() == {"FASTMRI_ROOT": "/proj"}
        assert os.environ.pop("FASTMRI_ROOT") == "/proj"
        assert "NOT_A_ROOT" not in os.environ
    (proj / "sub" / ".env").write_text("FASTMRI_ROOT=/sub\n")
    monkeypatch.chdir(proj / "sub")
    assert config.load_env() == {"FASTMRI_ROOT": "/sub"}


def test_registry_builds_the_port_unet(tmp_path):
    spec_path = PORT / "configs" / "knee_acl.yaml"
    model = registry.build_from_yaml(str(spec_path))
    assert isinstance(model, ResNetEncoderUNet)
    import yaml
    spec = yaml.safe_load(spec_path.read_text())["model"]
    assert spec["class_path"].startswith(
        "mri_acl_imagesegmentation_adsp_tpu_torch.")
    assert type(registry.build_from_spec(spec)) is type(model)
    assert registry.load_component(
        "mri_acl_imagesegmentation_adsp_tpu_torch.models.factory.build_unet"
    ) is registry.load_component(spec["class_path"])
    two = tmp_path / "two.yaml"
    two.write_text(yaml.safe_dump({"a": spec, "b": spec}))
    with pytest.raises(ValueError, match="Ambiguous"):
        registry.build_from_yaml(str(two))
    assert isinstance(registry.build_from_yaml(str(two), key="b"),
                      ResNetEncoderUNet)


def test_logger_json_fields_match_jax(tmp_path):
    """The same record through both formatters: the same JSON object."""
    record = logging.LogRecord("clf", logging.INFO, __file__, 7,
                               "epoch %d", (3,), None, func="fit")
    record.extra = {"val_auc": 0.9}
    record.step = 12
    logger.set_run_id("run-1")
    jlogger.set_run_id("run-1")
    ours = json.loads(logger.JsonFormatter().format(record))
    theirs = json.loads(jlogger.JsonFormatter().format(record))
    assert ours == theirs
    assert ours["msg"] == "epoch 3" and ours["val_auc"] == 0.9
    assert ours["step"] == 12 and ours["run_id"] == "run-1"
    log_file = tmp_path / "logs" / "run.jsonl"
    lg = logger.get_logger("port-remainder", str(log_file), console=False)
    assert logger.get_logger("port-remainder") is lg
    lg.info("hello", extra={"k": 1})
    for h in lg.handlers:
        h.flush()
    line = json.loads(log_file.read_text().splitlines()[-1])
    assert line["msg"] == "hello" and line["k"] == 1


@pytest.fixture(scope="module")
def h5_root(tmp_path_factory):
    """Two fastMRI single-coil .h5 files of the oracle's generator, written
    by the port's copy (its arrays bit-equal to the oracle's)."""
    root = tmp_path_factory.mktemp("h5")
    ours = np.random.default_rng(97)
    theirs = np.random.default_rng(97)
    for i in range(2):
        ksp, imgs = synthetic.synthetic_kspace_volume(ours, s=6, h=64, w=48)
        want_k, want_i = oracles.synthetic_kspace_volume(theirs, s=6, h=64,
                                                         w=48)
        np.testing.assert_array_equal(ksp, want_k)
        np.testing.assert_array_equal(imgs, want_i)
        synthetic.write_fake_fastmri_h5(str(root / f"vol{i}.h5"), ksp)
    return root


def test_cli_main_preview_and_preprocess(h5_root, tmp_path, capsys,
                                         monkeypatch):
    jmain.main(["--dataset", "fastmri", "--root", str(h5_root)])
    want = capsys.readouterr().out
    tmain.main(["--dataset", "fastmri", "--root", str(h5_root),
                "--device", "cpu"])
    assert capsys.readouterr().out == want
    assert "Dataset size: 12" in want
    out = tmp_path / "packs"
    tmain.main(["--dataset", "fastmri", "--root", str(h5_root), "--device",
                "cpu", "--root_dir", str(h5_root), "--out_dir", str(out),
                "--height", "32", "--width", "32"])
    assert "Preprocess finished for 2 volume(s)" in capsys.readouterr().out
    packs = sorted(p.name for p in out.iterdir())
    assert packs == ["vol0", "vol1"]
    assert (out / "vol0" / "volume.npz").is_file()
    monkeypatch.delenv("FASTMRI_ROOT", raising=False)
    with pytest.raises(ValueError, match="FASTMRI_ROOT"):
        tmain.build_adapter("fastmri", SimpleNamespace(root=None,
                                                       with_preproc=False))


def test_smoke_runs_one_record(h5_root, monkeypatch):
    res = smoke.run_smoke(str(h5_root), device="cpu")
    assert res["img_shape"] == (320, 320)
    assert np.isfinite(res["loss"]) and 0 <= res["pred_px"] <= 320 * 320
    assert smoke.main(["--root", str(h5_root), "--device", "cpu"]) == 0
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        smoke.run_smoke(str(h5_root), device="cpu")


REF_ARGS = {"k": 1, "aug": "light", "model": "unet", "encoder": "resnet34",
            "encoder_weights": "none", "classes": 1, "imagenet_norm": False,
            "batch_size": 8, "epochs": 50, "lr": 0.001, "weight_decay": 1e-4,
            "workers": 4, "loss": "dice_bce", "amp": True, "seed": 42,
            "logger": "csv", "save_val_probs": True, "max_grad_norm": 5.0}


def _fake_launcher(calls, dice):
    def launch(flags):
        calls.append(list(flags))
        run = Path(flags[flags.index("--out-dir") + 1])
        run.mkdir(parents=True, exist_ok=True)
        (run / "summary.json").write_text(json.dumps(
            {"best": {"val_dice": dice}}))
        return 0
    return launch


@pytest.mark.parametrize("extra", [
    ["--synthetic", "2", "--epochs", "1", "--min-dice", "0.5"],
    ["--skip-preprocess"],
    ["--dataset-root", "/data/raw", "--min-dice", "0.99"]],
    ids=["synthetic", "skip_preprocess", "real"])
def test_replay_gate_flags_match_jax(tmp_path, monkeypatch, capsys, extra):
    args_json = tmp_path / "args.json"
    ref = dict(REF_ARGS, amp=extra[0] != "--skip-preprocess")
    args_json.write_text(json.dumps(ref))
    work = tmp_path / "gate"
    common = ["--args-json", str(args_json), "--work-dir", str(work), *extra]
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jlauncher, "main", _fake_launcher(calls["jax"], 0.98))
    monkeypatch.setattr(launcher, "main", _fake_launcher(calls["port"], 0.98))
    rc = {"jax": jgate.main(common)}
    arrays = {}
    if "--synthetic" in extra:
        import h5py
        raw = work / "synthetic_raw"
        arrays = {p.name: h5py.File(p, "r")["kspace"][:]
                  for p in sorted(raw.iterdir())}
        for p in raw.iterdir():
            p.unlink()
    rc["port"] = replay_gate.main(common)
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 1
    want_rc = 0 if 0.98 >= float(
        extra[extra.index("--min-dice") + 1] if "--min-dice" in extra
        else replay_gate.PARITY_DICE) else 1
    assert rc == {"jax": want_rc, "port": want_rc}
    verdicts = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("{")]
    assert verdicts[0] == verdicts[1]
    for name, k in arrays.items():
        import h5py
        with h5py.File(work / "synthetic_raw" / name, "r") as hf:
            np.testing.assert_array_equal(hf["kspace"][:], k)
    if arrays:
        assert len(arrays) == 2
    replay_gate.main([*common, "--device", "cpu"])
    assert calls["port"][-1][-2:] == ["--device", "cpu"]

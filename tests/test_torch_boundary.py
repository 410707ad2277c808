"""Boundaries of the PyTorch port: it imports no JAX, and asking for the
card where there is none raises instead of running on the CPU."""
import ast
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "mri_acl_imagesegmentation_adsp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "mri_acl_imagesegmentation_adsp_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_cuda_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test is for one without")
    from mri_acl_imagesegmentation_adsp_tpu_torch.cli import serve
    from mri_acl_imagesegmentation_adsp_tpu_torch.cli.infer import (
        load_model_from_ckpt)
    from mri_acl_imagesegmentation_adsp_tpu_torch.data.preprocess import (
        MRIKneePreprocessor)
    from mri_acl_imagesegmentation_adsp_tpu_torch.models.factory import (
        build_unet)
    from mri_acl_imagesegmentation_adsp_tpu_torch.train.checkpoint import (
        save_best)

    with pytest.raises(RuntimeError, match="cuda"):
        MRIKneePreprocessor(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        MRIKneePreprocessor.ifft2c_single(      # default device
            np.ones((4, 4), np.complex64))
    ckpt = str(tmp_path / "best.ckpt")
    model = build_unet("unet", "resnet18")
    save_best(ckpt, model.state_dict(), {"model": "unet",
                                         "encoder": "resnet18"})
    with pytest.raises(RuntimeError, match="cuda"):
        load_model_from_ckpt(ckpt)                      # default device
    with pytest.raises(RuntimeError, match="cuda"):
        serve.create_server(SimpleNamespace(
            ckpt=ckpt, host="127.0.0.1", port=0, batch_size=2,
            warmup_shape="", device="cuda"))


def test_open_close_wrapper_checks_its_input():
    from mri_acl_imagesegmentation_adsp_tpu_torch.ops.kernels import (
        morphology)
    before = morphology.LAUNCHES
    m = torch.zeros(2, 8, 8, dtype=torch.uint8)
    with pytest.raises(TypeError):
        morphology.open_close(m.bool())
    with pytest.raises(ValueError):
        morphology.open_close(m[0])
    with pytest.raises(ValueError):
        morphology.open_close(torch.zeros(2, 0, 8, dtype=torch.uint8))
    with pytest.raises(ValueError):
        morphology.open_close(
            torch.zeros(2, 8, 16, dtype=torch.uint8)[..., ::2])
    # a CPU tensor takes the plain version and launches nothing
    out = morphology.open_close(torch.ones(2, 8, 8, dtype=torch.uint8))
    assert out.dtype == torch.uint8 and bool(out.all())
    assert morphology.LAUNCHES == before
    assert np.array_equal(morphology.open_close_reference(m).numpy(),
                          np.zeros((2, 8, 8), np.uint8))

"""The PyTorch serving daemon on the CPU (port 0), held against the JAX
daemon's ``_ModelRunner`` on the same weights: a random JAX ResNet18 U-Net,
saved in each package's own checkpoint format (the port's through
``state_dict_from_flax``)."""
import io
import json
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mri_acl_imagesegmentation_adsp_tpu.cli import serve as jax_serve
from mri_acl_imagesegmentation_adsp_tpu.models import build_unet as jax_build
from mri_acl_imagesegmentation_adsp_tpu.train import checkpoint as jax_ckpt
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import serve
from mri_acl_imagesegmentation_adsp_tpu_torch.models.convert import (
    state_dict_from_flax)
from mri_acl_imagesegmentation_adsp_tpu_torch.train import checkpoint
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.synthetic import (
    synthetic_kspace_pairs)

ARGS = {"model": "unet", "encoder": "resnet18", "k": 1, "classes": 1,
        "amp": False, "imagenet_norm": False}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    model = jax_build("unet", "resnet18", "none", in_ch=1, classes=1)
    v = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 1)),
                   train=True)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    jax_path, port_path = str(tmp / "jax.ckpt"), str(tmp / "port.ckpt")
    jax_ckpt.save_best(jax_path, params, stats, ARGS)
    checkpoint.save_best(port_path, state_dict_from_flax(params, stats), ARGS)
    server = serve.create_server(SimpleNamespace(
        ckpt=port_path, host="127.0.0.1", port=0, batch_size=4,
        pre_out_size="32,32", warmup_shape="2,32,32", device="cpu"))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    jax_runner = jax_serve._build_runner(SimpleNamespace(
        qtree=None, ckpt=jax_path, batch_size=4, pre_out_size="32,32"))
    try:
        yield "http://127.0.0.1:%d" % server.server_address[1], jax_runner
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def _post(url, **arrays):
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue())
    with urllib.request.urlopen(req, timeout=120) as r:
        return dict(np.load(io.BytesIO(r.read())))


def _status(url, **arrays):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, **arrays)
    return e.value.code


def test_healthz(served):
    url, _ = served
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        payload = json.loads(r.read())
    assert payload == {"status": "ok", "task": "segment", "k": 1,
                       "classes": 1, "source": "ckpt",
                       "requests": payload["requests"]}


def test_segment_kspace_matches_jax_runner(served):
    """Body masks bit-equal; model masks equal except where the JAX
    probability sits within 1e-5 of the threshold (none on this input);
    probabilities to 1e-4 (the iFFT and the convolutions sum in another
    order)."""
    url, jax_runner = served
    pair = synthetic_kspace_pairs(seed=7, s=6, h=64, w=48)
    got = _post(url + "/v1/segment_kspace?probs=1", kspace=pair)
    want = jax_runner.segment_kspace(pair, 0.5, True)
    assert got["mask"].shape == (6, 32, 32)
    np.testing.assert_array_equal(got["body_mask"], want["body_mask"])
    assert got["body_mask"].any()
    assert list(got["indices"]) == list(want["indices"]) == list(range(6))
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=1e-4,
                               atol=1e-4)
    near = np.abs(want["probs"][:, 0] - 0.5) < 1e-5
    np.testing.assert_array_equal(got["mask"][~near], want["mask"][~near])
    assert not near.any()
    np.testing.assert_array_equal(got["mask"], want["mask"])
    mid = _post(url + "/v1/segment_kspace?keep=0.3,0.7&threshold=0.4",
                kspace=pair)
    assert list(mid["indices"]) == [1, 2, 3] and "probs" not in mid


def test_segment_matches_jax_runner(served):
    url, jax_runner = served
    vol = np.random.default_rng(0).standard_normal((5, 32, 32)).astype(
        np.float32)
    got = _post(url + "/v1/segment?probs=1", img=vol)
    want = jax_runner.segment(vol, 0.5, True)
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=1e-4,
                               atol=1e-4)
    masks_only = _post(url + "/v1/segment", img=vol[:, None])
    assert set(masks_only) == {"mask"}
    np.testing.assert_array_equal(masks_only["mask"], got["mask"])


def test_bad_requests(served):
    url, _ = served
    pair = np.zeros((2, 16, 16, 2), np.float32)
    assert _status(url + "/v1/segment_kspace", img=pair) == 400
    assert _status(url + "/v1/segment_kspace?keep=1,0", kspace=pair) == 400
    assert _status(url + "/v1/segment_kspace",
                   kspace=np.zeros((2, 3, 16, 16, 2), np.float32)) == 400
    assert _status(url + "/v1/segment",
                   img=np.zeros((4, 4), np.float32)) == 400
    assert _status(url + "/v1/classify", x=pair) == 404


@pytest.mark.parametrize("flag", [["--tta", "hflip"], ["--qtree", "q.npz"],
                                  ["--microbatch-window-ms", "5"],
                                  ["--task", "recon"],
                                  ["--data-parallel", "2"]])
def test_main_refuses_what_is_not_ported(flag, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--ckpt", "unused.ckpt", *flag])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "unrecognized arguments" in err and flag[0] in err
    with pytest.raises(SystemExit):
        serve.main(["--help"])
    assert flag[0] in "".join(capsys.readouterr().out.split())

"""The PyTorch serving daemon on the CPU (port 0), held against the JAX
daemon's ``_ModelRunner`` on the same weights: a random JAX ResNet18 U-Net,
saved in each package's own checkpoint format (the port's through
``state_dict_from_flax``). A second daemon serves with ``--tta hflip`` and
``--microbatch-window-ms``: its answers to concurrent requests are held
against sequential serving and the JAX runner, and its ``/metricsz``
counts against the requests sent."""
import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_acl_imagesegmentation_adsp_tpu.cli import serve as jax_serve
from mri_acl_imagesegmentation_adsp_tpu.models import build_unet as jax_build
from mri_acl_imagesegmentation_adsp_tpu.train import checkpoint as jax_ckpt
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import serve
from mri_acl_imagesegmentation_adsp_tpu_torch.models.convert import (
    state_dict_from_flax)
from mri_acl_imagesegmentation_adsp_tpu_torch.train import checkpoint
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.synthetic import (
    synthetic_kspace_pairs, synthetic_multicoil_kspace_pairs)

ARGS = {"model": "unet", "encoder": "resnet18", "k": 1, "classes": 1,
        "amp": False, "imagenet_norm": False}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """One random JAX U-Net in both packages' checkpoint formats."""
    tmp = tmp_path_factory.mktemp("serve")
    model = jax_build("unet", "resnet18", "none", in_ch=1, classes=1)
    v = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 1)),
                   train=True)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    jax_path, port_path = str(tmp / "jax.ckpt"), str(tmp / "port.ckpt")
    jax_ckpt.save_best(jax_path, params, stats, ARGS)
    checkpoint.save_best(port_path, state_dict_from_flax(params, stats), ARGS)
    return jax_path, port_path


def _start(port_path, **extra):
    server = serve.create_server(SimpleNamespace(
        ckpt=port_path, host="127.0.0.1", port=0, batch_size=4,
        pre_out_size="32,32", warmup_shape="2,32,32", device="cpu", **extra))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    server.RequestHandlerClass.runner.close()
    thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def served(ckpts):
    jax_path, port_path = ckpts
    server, thread = _start(port_path)
    jax_runner = jax_serve._build_runner(SimpleNamespace(
        qtree=None, ckpt=jax_path, batch_size=4, pre_out_size="32,32"))
    try:
        yield "http://127.0.0.1:%d" % server.server_address[1], jax_runner
    finally:
        _stop(server, thread)


def _post(url, **arrays):
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue())
    with urllib.request.urlopen(req, timeout=120) as r:
        return dict(np.load(io.BytesIO(r.read())))


def _status(url, **arrays):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, **arrays)
    e.value.close()
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


def test_segment_kspace_multicoil_matches_jax_runner(served):
    """Multi-coil (S, C, H, W, 2) k-space: per-coil iFFT and RSS in front
    of the chain, as the JAX runner takes it; the same bounds as the
    single-coil request."""
    url, jax_runner = served
    pair = synthetic_multicoil_kspace_pairs(seed=8, s=4, c=3, h=64, w=48)
    got = _post(url + "/v1/segment_kspace?probs=1", kspace=pair)
    want = jax_runner.segment_kspace(pair, 0.5, True)
    assert got["mask"].shape == (4, 32, 32)
    np.testing.assert_array_equal(got["body_mask"], want["body_mask"])
    assert got["body_mask"].any()
    assert list(got["indices"]) == list(want["indices"]) == list(range(4))
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=1e-4,
                               atol=1e-4)
    near = np.abs(want["probs"][:, 0] - 0.5) < 1e-5
    assert not near.any()
    np.testing.assert_array_equal(got["mask"], want["mask"])


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
                   kspace=np.zeros((2, 3, 16, 16, 3), np.float32)) == 400
    assert _status(url + "/v1/segment_kspace",
                   kspace=np.zeros((1, 2, 3, 16, 16, 2), np.float32)) == 400
    assert _status(url + "/v1/segment",
                   img=np.zeros((4, 4), np.float32)) == 400
    assert _status(url + "/v1/classify", x=pair) == 404


@pytest.mark.parametrize("flag", [["--qtree", "q.npz"], ["--task", "recon"],
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


def _metricsz(url):
    with urllib.request.urlopen(url + "/metricsz", timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    return {ln.split()[0]: float(ln.split()[1]) for ln in text.splitlines()
            if not ln.startswith("#")}


def _volumes():
    rng = np.random.default_rng(8)
    return ([rng.standard_normal((s, 32, 32)).astype(np.float32)
             for s in (3, 5, 2, 4)]
            + [rng.standard_normal((3, 1, 32, 32)).astype(np.float32),
               rng.standard_normal((2, 64, 32)).astype(np.float32)])


def test_microbatched_tta_serving_matches_sequential(ckpts):
    """Six concurrent /v1/segment requests (two shapes, masks and
    probabilities) and one poisoned request (0 slices) to a daemon with
    --tta hflip --microbatch-window-ms 50: each answer equals sequential
    serving of the same model (probabilities within 1e-5; masks equal
    except where the sequential probability lies within 1e-5 of 0.5) and
    the JAX runner with --tta hflip (1e-4); only the poisoned request
    fails, and /metricsz counts what was served."""
    jax_path, port_path = ckpts
    server, thread = _start(port_path, tta="hflip", microbatch_window_ms=50)
    url = "http://127.0.0.1:%d" % server.server_address[1]
    seq = serve._build_runner(SimpleNamespace(
        ckpt=port_path, batch_size=4, device="cpu", tta="hflip"))
    jax_runner = jax_serve._build_runner(SimpleNamespace(
        qtree=None, ckpt=jax_path, batch_size=4, pre_out_size="32,32",
        tta="hflip"))
    vols = _volumes()
    results, codes = {}, {}

    def client(i):
        if i == len(vols):
            codes[i] = _status(url + "/v1/segment",
                               img=np.zeros((0, 32, 32), np.float32))
            return
        q = "?probs=1" if i % 2 else "?threshold=0.4"
        results[i] = _post(url + "/v1/segment" + q, img=vols[i])

    try:
        assert _metricsz(url)["serve_requests_total"] == 0   # after warm-up
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(vols) + 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert codes == {len(vols): 400}
        for i, vol in enumerate(vols):
            want = seq.segment(vol, 0.5 if i % 2 else 0.4, True)
            thr = 0.5 if i % 2 else 0.4
            near = np.abs(want["probs"][:, 0] - thr) < 1e-5
            np.testing.assert_array_equal(results[i]["mask"][~near],
                                          want["mask"][~near])
            if i % 2:
                np.testing.assert_allclose(results[i]["probs"],
                                           want["probs"], rtol=0, atol=1e-5)
            else:
                assert set(results[i]) == {"mask"}
        np.testing.assert_allclose(
            results[1]["probs"], jax_runner.segment(vols[1], 0.5, True)[
                "probs"], rtol=1e-4, atol=1e-4)
        m = _metricsz(url)
        assert m["serve_requests_total"] == len(vols)
        assert m["serve_slices_total"] == sum(v.shape[0] for v in vols)
        assert m["serve_errors_total"] == 1
        assert m["serve_busy_seconds_total"] > 0
        assert m["serve_last_latency_seconds"] > 0
    finally:
        _stop(server, thread)


class _FakeRunner:
    """Records the groups a micro-batcher hands it; a volume of NaNs
    poisons its group."""

    def __init__(self):
        self.groups = []

    def segment_many(self, vols, thr=None):
        self.groups.append((len(vols), thr))
        if any(np.isnan(v).any() for v in vols):
            raise RuntimeError("poisoned")
        return [v * 2 if thr is None else (v > thr).astype(np.uint8)
                for v in vols]


def test_microbatcher_groups_by_shape_and_mode_and_retries():
    runner = _FakeRunner()
    batcher = serve._MicroBatcher(runner, window_ms=300)
    vols = [np.full((2, 4, 4), i, np.float32) for i in range(4)]
    vols.append(np.full((1, 8, 4), 5, np.float32))
    vols.append(np.full((2, 4, 4), np.nan, np.float32))
    thrs = [None, None, 1.5, 1.5, None, None]
    out, err = {}, {}

    def client(i):
        try:
            out[i] = batcher.submit(vols[i], thrs[i])
        except RuntimeError as e:
            err[i] = str(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(vols))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher.close()
    assert err == {5: "poisoned"}
    for i in range(5):
        want = vols[i] * 2 if thrs[i] is None else (vols[i] > thrs[i])
        np.testing.assert_array_equal(out[i], want.astype(out[i].dtype))
    # one window: (4,4)/probs with the poisoned volume, its three volumes
    # retried one by one, (4,4)/1.5 and (8,4)/probs
    assert sorted(runner.groups) == [(1, None)] * 4 + [(2, 1.5), (3, None)]
    with pytest.raises(RuntimeError):
        batcher.submit(vols[0])                      # closed


def test_runner_counters_hold_under_contention():
    """Sixteen threads record 200 requests each with a short switch
    interval; the counters lose none."""
    runner = serve._ModelRunner(lambda x: x, 1, 1, "test", 4, device="cpu")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            runner._record(time.perf_counter(), 3) for _ in range(200)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert runner.requests == 3200 and runner.slices == 9600


@pytest.mark.parametrize("classes", [1, 3])
def test_runner_probs_request_masks_as_mask_only_request(classes):
    """A request for probabilities gets the mask the mask-only request
    gets: '>' threshold for one class, the argmax of three."""
    runner = serve._ModelRunner(
        lambda x: torch.cat([x, -x, 0.5 * x][:classes], dim=1), 1, classes,
        "test", 4, device="cpu")
    vol = np.random.default_rng(2).standard_normal((5, 8, 8)).astype(
        np.float32)
    both = runner.segment(vol, 0.3, True)
    mask = runner.segment(vol, 0.3, False)["mask"]
    assert both["mask"].dtype == np.uint8
    np.testing.assert_array_equal(both["mask"], mask)
    want = (both["probs"][:, 0] > 0.3 if classes == 1
            else both["probs"].argmax(axis=1))
    np.testing.assert_array_equal(both["mask"], want)


def test_main_accepts_tta_and_microbatching(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--help"])
    text = "".join(capsys.readouterr().out.split())
    assert "--tta{none,hflip}" in text and "--microbatch-window-ms" in text

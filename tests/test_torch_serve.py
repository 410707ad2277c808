"""The PyTorch serving daemon on the CPU (port 0), held against the JAX
daemon's ``_ModelRunner`` on the same weights: a random JAX ResNet18 U-Net,
saved in each package's own checkpoint format (the port's through
``state_dict_from_flax``). A second daemon serves with ``--tta hflip`` and
``--microbatch-window-ms``: its answers to concurrent requests are held
against sequential serving and the JAX runner, and its ``/metricsz``
counts against the requests sent. An ``amp`` checkpoint serves in bf16
(probabilities equal to the bf16 apply function's, not the f32 model's),
and a ``--qtree`` daemon (int8, bf16 compute) answers ``/v1/segment`` and
``/v1/segment_kspace`` with what its runner computes in process; on the
same artifact the JAX daemon's runner agrees within 1e-6 without TTA, and
with ``--tta hflip`` the JAX engine run op by op agrees within 1e-6 (the
JAX runner jits the flip together with the int8 engine, and that program
does not reproduce its own op-by-op logits, so it is not the yardstick)."""
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

from mri_acl_imagesegmentation_adsp_tpu.cli import quantize as jax_quantize
from mri_acl_imagesegmentation_adsp_tpu.cli import serve as jax_serve
from mri_acl_imagesegmentation_adsp_tpu.infer import segment as jax_seg
from mri_acl_imagesegmentation_adsp_tpu.models import build_unet as jax_build
from mri_acl_imagesegmentation_adsp_tpu.train import checkpoint as jax_ckpt
from test_torch_infer import _amp_ckpt, one_thread  # noqa: F401

from mri_acl_imagesegmentation_adsp_tpu_torch.cli import infer, quantize, serve
from mri_acl_imagesegmentation_adsp_tpu_torch.infer.segment import (
    segment_volume_2d, tta_wrap)
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


def test_data_parallel_daemon_matches_one_device(ckpts, served):
    """``--data-parallel 2`` on the CPU: each batch of 4 splits over two
    replicas (2 slices each; 5 slices pad to 8); the /v1/segment reply's
    masks are the one-device daemon's bit for bit and its probabilities
    equal them to 1e-5 (a batch of 2 sums its convolutions in another
    order than a batch of 4)."""
    url1, _ = served
    server, thread = _start(ckpts[1], data_parallel=2)
    try:
        runner = server.RequestHandlerClass.runner
        assert runner.apply_fn.n_devices == 2
        url = "http://127.0.0.1:%d" % server.server_address[1]
        vol = np.random.default_rng(0).standard_normal((5, 32, 32)).astype(
            np.float32)
        got = _post(url + "/v1/segment?probs=1", img=vol)
        want = _post(url1 + "/v1/segment?probs=1", img=vol)
        np.testing.assert_array_equal(got["mask"], want["mask"])
        np.testing.assert_allclose(got["probs"], want["probs"], rtol=0,
                                   atol=1e-5)
    finally:
        _stop(server, thread)


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


@pytest.mark.parametrize("flag", [["--task", "classify"], ["--task", "recon"],
                                  ["--data-parallel", "2"]])
def test_main_refuses_what_is_not_ported(flag, capsys, monkeypatch):
    """``--data-parallel 2`` reaches the server (segmentation on two
    replicas) and is refused with ``--task recon``, which serves on one
    device; ``--task recon`` and ``--task classify`` are accepted and reach
    the server with their task and checkpoint (and refuse a ``--qtree``)."""
    seen = []

    def create_server(args):
        seen.append(args)
        raise KeyboardInterrupt      # stop before binding anything
    monkeypatch.setattr(serve, "create_server", create_server)
    if flag[0] == "--task":
        with pytest.raises(KeyboardInterrupt):
            serve.main(["--ckpt", "unused.ckpt", *flag])
        assert seen[0].task == flag[1] and seen[0].ckpt == "unused.ckpt"
        with pytest.raises(SystemExit) as e:     # a qtree is neither model
            serve.main(["--qtree", "unused.npz", *flag])
        assert e.value.code == 2
        capsys.readouterr()
    else:
        with pytest.raises(KeyboardInterrupt):
            serve.main(["--ckpt", "unused.ckpt", *flag])
        assert seen[0].data_parallel == 2 and seen[0].task == "segment"
        with pytest.raises(SystemExit) as e:
            serve.main(["--ckpt", "unused.ckpt", "--task", "recon", *flag])
        assert e.value.code == 2 and len(seen) == 1
        assert "--data-parallel 2" in capsys.readouterr().err
        with pytest.raises(ValueError, match="--task classify serves on one"):
            serve._build_runner(SimpleNamespace(
                task="classify", ckpt="unused.ckpt", data_parallel=2,
                device="cpu"))
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


def test_amp_checkpoint_serves_in_bf16(tmp_path):
    ck, _, _ = _amp_ckpt(tmp_path, "unet")
    runner = serve._build_runner(SimpleNamespace(
        ckpt=ck, batch_size=4, device="cpu"))
    assert runner.compute_dtype == torch.bfloat16 and runner.source == "ckpt"
    vol = np.random.default_rng(3).standard_normal((5, 64, 64)).astype(
        np.float32)
    got = runner.segment(vol, 0.5, True)["probs"]
    model, _ = infer.load_model_from_ckpt(ck, "cpu")
    want = segment_volume_2d(
        infer.model_apply_fn(model, lambda x: x), torch.from_numpy(vol),
        batch_size=4)
    np.testing.assert_array_equal(got, want.numpy())
    f32 = segment_volume_2d(model, torch.from_numpy(vol), batch_size=4)
    assert not np.array_equal(got, f32.numpy())


def test_qtree_daemon_matches_in_process_and_jax(tmp_path):
    """``--qtree`` with ``--tta hflip`` and ``--microbatch-window-ms``: one
    /v1/segment_kspace and two concurrent /v1/segment requests, each
    answer the in-process runner's; /healthz says ``qtree``; /metricsz
    counts the three."""
    ck, _, _ = _amp_ckpt(tmp_path, "unet")
    rng = np.random.default_rng(9)
    d = tmp_path / "vol0"
    d.mkdir()
    np.savez(d / "volume.npz", img=rng.standard_normal(
        (6, 1, 32, 32)).astype(np.float32), msk=np.zeros((6, 32, 32),
                                                        np.uint8))
    (tmp_path / "l.txt").write_text(str(d / "volume.npz"))
    q = str(tmp_path / "q.npz")
    assert quantize.main(["--ckpt", ck, "--list", str(tmp_path / "l.txt"),
                          "--out", q, "--device", "cpu"]) == 0
    server = serve.create_server(SimpleNamespace(
        ckpt=None, qtree=q, host="127.0.0.1", port=0, batch_size=4,
        pre_out_size="32,32", warmup_shape="2,32,32", device="cpu",
        tta="hflip", microbatch_window_ms=50))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://127.0.0.1:%d" % server.server_address[1]
    runner = server.RequestHandlerClass.runner
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["source"] == "qtree" and health["k"] == 1
        assert runner.compute_dtype == torch.bfloat16
        pair = synthetic_kspace_pairs(seed=7, s=4, h=64, w=48)
        got = _post(url + "/v1/segment_kspace?probs=1", kspace=pair)
        want = runner.segment_kspace(pair, 0.5, True)
        for key in ("mask", "body_mask", "probs"):
            np.testing.assert_array_equal(got[key], want[key])
        vols = [rng.standard_normal((s, 32, 32)).astype(np.float32)
                for s in (3, 5)]
        results = {}
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, _post(url + "/v1/segment?probs=1", img=vols[i])))
            for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        eng, tree, _ = quantize.load_engine(q)
        for i, vol in enumerate(vols):
            want = segment_volume_2d(
                lambda x: eng.apply(tree, x), torch.from_numpy(vol),
                batch_size=4, tta="hflip")
            np.testing.assert_array_equal(results[i]["probs"], want.numpy())
        m = _metricsz(url)
        assert m["serve_requests_total"] == 3 + 1   # + the in-process one
        jax_runner = jax_serve._build_runner(SimpleNamespace(
            qtree=q, ckpt=None, batch_size=4, pre_out_size="32,32"))
        plain = segment_volume_2d(lambda x: eng.apply(tree, x),
                                  torch.from_numpy(vols[1]), batch_size=4)
        np.testing.assert_allclose(
            plain.numpy(), jax_runner.segment(vols[1], 0.5, True)["probs"],
            rtol=0, atol=1e-6)
        jeng, jtree, _ = jax_quantize.load_engine(q)
        jlogits = np.asarray(jax_seg.tta_wrap(
            lambda x: jeng.apply(jtree, x), 1, "hflip")(
                jnp.asarray(vols[1][..., None])))
        np.testing.assert_allclose(
            results[1]["probs"][:, 0], 1 / (1 + np.exp(-jlogits[..., 0])),
            rtol=0, atol=1e-6)
    finally:
        _stop(server, thread)

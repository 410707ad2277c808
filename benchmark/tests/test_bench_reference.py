"""The plain reference against the port, at small sizes on the CPU in
float32, where the two must agree to rounding."""

import pytest
import torch

from benchmark import harness
from benchmark.reference.kspace_chain import chain
from benchmark.reference.models import Net
from benchmark.run import run_cell
from benchmark.traffic.synthetic import kspace_pairs, load_panels
from benchmark.traffic.weights import make_weights


@pytest.mark.parametrize("model", ["unet"])
def test_plain_model_is_the_ports(model):
    from mri_acl_imagesegmentation_adsp_tpu_torch.models.factory import (
        build_unet)
    params, running = make_weights(model, torch.Generator().manual_seed(3))
    net = build_unet(model, "resnet34", in_ch=1, classes=1)
    state = dict(params)
    for n, (mean, var) in running.items():
        state[n + ".running_mean"], state[n + ".running_var"] = mean, var
    missing, unexpected = net.load_state_dict(state, strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing)
    x = torch.randn(2, 1, 64, 64, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        net.eval()
        ev = Net(model, params, train=False, stats=running)(x)
        assert torch.allclose(net(x), ev, rtol=1e-5, atol=1e-5 * float(
            ev.abs().max()))
        net.train()
        tr = Net(model, params, train=True)(x)
        assert torch.allclose(net(x), tr, rtol=1e-4, atol=1e-4 * float(
            tr.abs().max()))


def test_kspace_chain_is_the_ports():
    from mri_acl_imagesegmentation_adsp_tpu_torch.data.preprocess import (
        MRIKneePreprocessor)
    panels = load_panels(harness.HERE / "traffic" / "knee_panels.npz", "cpu")
    k = kspace_pairs(torch.Generator().manual_seed(5), panels, 3, 640, 368)
    pre = MRIKneePreprocessor(out_size=(320, 320), slice_keep=(0.0, 1.0),
                              device="cpu")
    out = pre.preprocess_volume_pairs(k.numpy())
    x, body = chain(k)
    assert torch.equal(out["mask"].bool(), body)
    assert 0.1 < float(body.double().mean()) < 0.6
    assert float((out["tensor"].double() - x).abs().max()) < 1e-4
    _, body16 = chain(k, bf16=True)
    assert int((body16 != body).sum()) > 50      # the control moves it


def test_reference_steps_follow_the_ports_engine():
    """The generator's first steps, in float32 (no autocast), against the
    plain steps: augmentation, loss, clip and AdamW redone from the same
    weights, rows and seed agree to rounding: the first step's loss to the
    bit here; later steps and the parameters' change drift further, as
    Adam's first updates take the sign of every gradient element, near
    zero ones too."""
    cell = harness.cell("train.unet_r34.b128")
    cell["config"]["image_size"] = 64
    cell["config"]["recipe"]["amp"] = False
    cell["traffic"].update(volumes=2, slices_per_volume=8, batch=4)
    res = run_cell(cell, 2 ** 31 + 11, 0.1, False, torch.device("cpu"), 0.0)
    r = res["readings"]
    assert r["loss_gap_first"] < 1e-6 and r["loss_gap"] < 1e-3
    assert r["grad_gap_median"] < 1e-4 and r["grad_gap"] < 1e-2
    assert r["update_gap_median"] < 1e-2

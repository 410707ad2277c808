"""Seeded synthetic knee slices and their single-coil k-space, in numpy.

The port's own copy of ``tests/oracles.py:122-140`` (``synthetic_knee``,
``synthetic_kspace_volume``): a bright Gaussian blob on a dark noisy
background with sparse bright specks, like a magnitude MRI slice, and its
centered orthonormal 2-D FFT as a fastMRI-style ``(S, H, W, 2)`` float32
real pair (the oracle's complex64 k-space split into real and imaginary
parts, bit for bit; ``scripts/make_corpus.py``'s volume ``i`` is
``synthetic_knee_volume(2024 + i, 112, 368, 320)`` and its k-space); multi-coil k-space, ``(S, C, H, W, 2)``, of the same slices
seen through smooth complex coil sensitivities; the masks that hold the
connected-components kernel at its edges; and a seeded ResNet state_dict
in torchvision's layout, the kind of file ``encoder_weights`` loads."""

from __future__ import annotations

import numpy as np


def synthetic_knee(rng: np.random.Generator, h: int = 128,
                   w: int = 128) -> np.ndarray:
    """One ``(h, w)`` float32 magnitude slice."""
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    cy, cx = h / 2 + rng.uniform(-8, 8), w / 2 + rng.uniform(-8, 8)
    r = min(h, w) * rng.uniform(0.25, 0.35)
    blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
                  ).astype(np.float32)
    noise = rng.random((h, w)).astype(np.float32) * 0.05
    speck = (rng.random((h, w)) > 0.995).astype(np.float32) * 0.9
    return blob + noise + speck


def _fft2c(x: np.ndarray) -> np.ndarray:
    return np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(x, axes=(-2, -1)),
                                       norm="ortho"), axes=(-2, -1))


def synthetic_knee_volume(seed: int, s: int = 8, h: int = 640,
                          w: int = 368) -> np.ndarray:
    """``(s, h, w)`` float32 synthetic slices made from ``seed``."""
    rng = np.random.default_rng(seed)
    return np.stack([synthetic_knee(rng, h, w) for _ in range(s)])


def synthetic_kspace_pairs(seed: int, s: int = 8, h: int = 640,
                           w: int = 368) -> np.ndarray:
    """``(s, h, w, 2)`` float32 k-space of ``s`` synthetic slices made from
    ``seed`` (the fastMRI knee single-coil layout at the defaults)."""
    ksp = _fft2c(synthetic_knee_volume(seed, s, h, w))
    return np.stack([ksp.real, ksp.imag], axis=-1).astype(np.float32)


def coil_maps(rng: np.random.Generator, c: int, h: int,
              w: int) -> np.ndarray:
    """``(c, h, w)`` complex64 coil sensitivities: coil ``j`` a broad
    Gaussian centred on an ellipse around the image at angle ``2 pi j / c``
    (jittered), times a slow random phase ramp."""
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    maps = np.empty((c, h, w), np.complex64)
    for j in range(c):
        ang = 2 * np.pi * j / c + rng.uniform(-0.2, 0.2)
        cy = h / 2 + 0.6 * h * np.sin(ang)
        cx = w / 2 + 0.6 * w * np.cos(ang)
        width = 0.5 * max(h, w) * rng.uniform(0.8, 1.2)
        mag = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * width ** 2))
        phase = (rng.uniform(-2, 2) * yy / h + rng.uniform(-2, 2) * xx / w
                 + rng.uniform(0, 2 * np.pi))
        maps[j] = mag * np.exp(1j * phase)
    return maps


def synthetic_multicoil_kspace_pairs(seed: int, s: int = 8, c: int = 15,
                                     h: int = 640,
                                     w: int = 368) -> np.ndarray:
    """``(s, c, h, w, 2)`` float32 k-space of ``s`` synthetic slices seen
    by ``c`` coils (:func:`coil_maps`, one set for the volume), made from
    ``seed``: the fastMRI knee multi-coil layout at the defaults."""
    rng = np.random.default_rng(seed)
    maps = coil_maps(rng, c, h, w)
    out = np.empty((s, c, h, w, 2), np.float32)
    for i in range(s):
        ksp = _fft2c(maps * synthetic_knee(rng, h, w))
        out[i, ..., 0] = ksp.real
        out[i, ..., 1] = ksp.imag
    return out


def serpentine(h: int, w: int) -> np.ndarray:
    """One corridor through an ``(h, w)`` mask: every other row, joined at
    alternate ends, so row and column sweeps settle it only one turn a
    sweep (about ``h / 2`` sweeps)."""
    m = np.zeros((h, w), bool)
    m[0::2, :] = True
    for i, r in enumerate(range(0, h - 2, 2)):
        m[r + 1, w - 1 if i % 2 == 0 else 0] = True
    return m


def comb(h: int, w: int) -> np.ndarray:
    """A comb in an ``(h, w)`` mask: teeth down every other column, joined
    by the last row, so the component's minimum (the first tooth's top)
    reaches the other teeth only through the tiles along the last row."""
    m = np.zeros((h, w), bool)
    m[:, 0::2] = True
    m[-1, :] = True
    return m


def component_masks(rng: np.random.Generator,
                    widths=(1, 31, 32, 33, 368, 369), heights=(1, 37),
                    densities=(0.3, 0.6, 0.9),
                    maze_hw=(640, 368)) -> list:
    """``(name, mask)`` cases for connected components, each mask a bool
    ``(S, H, W)`` stack: every width at every height, one slice per density;
    all foreground and all background; a checkerboard and its inverse (no
    two 4-neighbours joined); a serpentine maze of ``maze_hw``; one-pixel
    rings, nested; components that touch every border; a comb of
    ``maze_hw``."""
    cases = []
    for w in widths:
        for h in heights:
            cases.append((f"w{w}_h{h}", np.stack(
                [rng.random((h, w)) < d for d in densities])))
    cases.append(("all_foreground", np.ones((2, 37, 45), bool)))
    cases.append(("all_background", np.zeros((2, 37, 45), bool)))
    yy, xx = np.mgrid[:37, :45]
    board = (yy + xx) % 2 == 0
    cases.append(("checkerboard", np.stack([board, ~board])))
    cases.append(("maze", serpentine(*maze_hw)[None]))
    cases.append(("comb", comb(*maze_hw)[None]))
    ring = np.zeros((40, 50), bool)
    ring[3, 3:47] = ring[36, 3:47] = True
    ring[3:37, 3] = ring[3:37, 46] = True
    inner = ring.copy()
    inner[10, 10:40] = inner[29, 10:40] = True
    inner[10:30, 10] = inner[10:30, 39] = True
    cases.append(("rings", np.stack([ring, inner])))
    edges = np.zeros((40, 50), bool)
    edges[0, 5:20] = edges[39, 30:45] = True
    edges[8:30, 0] = edges[12:35, 49] = True
    edges[0:6, 49] = edges[34:40, 0] = True
    frame = np.zeros((40, 50), bool)
    frame[[0, -1], :] = frame[:, [0, -1]] = True
    cases.append(("borders", np.stack([edges, frame])))
    return cases


def torchvision_resnet_state_dict(encoder: str = "resnet34", seed: int = 0,
                                  in_ch: int = 3) -> dict:
    """``{name: float32 array}`` of a ResNet18/34/50 in torchvision's key
    layout (``conv1``, ``bn1``, ``layer{s}.{b}.conv{i}`` / ``bn{i}`` /
    ``downsample.{0,1}``, ``fc``), seeded: He-normal convs, BN affines and
    running statistics away from the identity."""
    from ..models.unet2d import RESNET_CFG
    rng = np.random.default_rng(seed)
    sd: dict = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = (rng.standard_normal((cout, cin, k, k))
                                * np.sqrt(2.0 / (cin * k * k))
                                ).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rng.standard_normal(c)).astype(
            np.float32)
        sd[f"{name}.running_mean"] = (0.1 * rng.standard_normal(c)).astype(
            np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c).astype(
            np.float32)
        sd[f"{name}.num_batches_tracked"] = np.asarray(0, np.int64)

    blocks, bottleneck = RESNET_CFG[encoder]
    conv("conv1", 64, in_ch, 7)
    bn("bn1", 64)
    cin = 64
    for stage, (n, width) in enumerate(zip(blocks, (64, 128, 256, 512)),
                                       start=1):
        for b in range(n):
            stride = 2 if (stage > 1 and b == 0) else 1
            p = f"layer{stage}.{b}"
            cout = width * 4 if bottleneck else width
            shapes = ([(width, cin, 1), (width, width, 3), (cout, width, 1)]
                      if bottleneck else [(width, cin, 3), (width, width, 3)])
            for i, (o, c, k) in enumerate(shapes, start=1):
                conv(f"{p}.conv{i}", o, c, k)
                bn(f"{p}.bn{i}", o)
            if stride != 1 or cin != cout:
                conv(f"{p}.downsample.0", cout, cin, 1)
                bn(f"{p}.downsample.1", cout)
            cin = cout
    sd["fc.weight"] = (0.01 * rng.standard_normal((1000, cin))).astype(
        np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return sd

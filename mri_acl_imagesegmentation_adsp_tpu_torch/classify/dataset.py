"""Classification slice datasets driven by a CSV datasheet.

The port's own copy of ``mri_acl_imagesegmentation_adsp_tpu/classify/
dataset.py`` (the vendored ``load_fastmri_data_convnext_t2.py`` and
``load_fastmri_data_convnext_diff.py``): the datasheet's rows of one
``data_split``, labels ``PIRADS > 2``, class-balanced BCE weights
``[mean(y), 1 - mean(y)]``; T2: the ``reconstruction_rss`` slice ->
augmentation -> 224 center crop -> normalisation; DWI: the (b1500, ADC)
slice pair -> joint augmentation -> 224 cubic resize -> normalisations ->
a 2-channel stack. Items are numpy ``(C, H, W)`` float32 and a float32
label; ``batches`` stacks them in the JAX package's order.

Reading the slices needs h5py and the datasheet pandas; opening a dataset
without either raises an ImportError that names it, h5py first.
"""

from __future__ import annotations

import os
import random
from typing import List, Tuple

import numpy as np
import torch

from ..native import import_h5py
from .augment import augment_image_diffusion, augment_image_t2
from .image_utils import (center_crop_2d, norm_adc, norm_b1500,
                          normalisation_2d, resize_2d)


def weighted_bce_loss(logits: torch.Tensor, targets: torch.Tensor,
                      weights: Tuple[float, float]) -> torch.Tensor:
    """Class-weighted BCE with logits, the mean over samples of
    ``weights[label] * (max(x, 0) - x t + log1p(exp(-|x|)))`` in f32."""
    x = logits.float().reshape(-1)
    t = targets.float().reshape(-1)
    w = torch.where(t > 0.5, weights[1], weights[0]).to(x)
    loss = torch.clamp_min(x, 0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return torch.mean(w * loss)


def _import_pandas(what: str):
    try:
        import pandas as pd
    except ImportError as exc:
        raise ImportError(f"{what} needs pandas, which is not installed "
                          "here") from exc
    return pd


class _BaseSheetDataset:
    SPLIT_COL = "data_split"

    def __init__(self, datasheet: str, datapath: str, augment: bool,
                 istrain: bool, isval: bool, istest: bool):
        import_h5py("a classification slice dataset")
        pd = _import_pandas("a classification slice dataset")
        self.aug = int(augment)
        data = pd.read_csv(datasheet)
        if istrain:
            split = "training"
        else:
            split = "validation" if isval else "test"
            self.aug = 0
        data = data[data[self.SPLIT_COL] == split].reset_index(drop=True)

        self.paths: List[str] = []
        self.labels: List[int] = []
        self.nums: List[int] = []
        self.slice_num: List[int] = []
        for i in range(len(data)):
            file_ = data["fastmri_rawfile"].iloc[i]
            fol = os.path.join(str(data["folder"].iloc[i]))
            self.paths.append(os.path.join(datapath, fol, file_))
            self.labels.append(int(data["PIRADS"].iloc[i] > 2))
            self.nums.append(int(data["fastmri_pt_id"].iloc[i]))
            self.slice_num.append(int(data["slice"].iloc[i]) - 1)  # 1-based

        self.labels = np.asarray(self.labels)
        neg_weight = float(np.mean(self.labels)) if len(self.labels) else 0.5
        self.weights = [neg_weight, 1 - neg_weight]

    def weighted_loss(self, prediction, target):
        return weighted_bce_loss(prediction, target, tuple(self.weights))

    def __len__(self):
        return len(self.paths)

    def batches(self, batch_size: int, shuffle: bool, seed: int = 0):
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, len(order), batch_size):
            chunk = order[start:start + batch_size]
            xs, ys = zip(*(self[int(i)] for i in chunk))
            yield np.stack(xs), np.stack(ys)


class T2SliceDataset(_BaseSheetDataset):
    """T2 ``reconstruction_rss`` slices, 1 channel."""

    def __init__(self, datasheet, datapath, norm_type=1, augment=False,
                 saveims=False, rundir="", istrain=True, isval=False,
                 istest=False):
        super().__init__(datasheet, datapath, augment, istrain, isval, istest)
        self.norm_type = norm_type

    def __getitem__(self, index: int):
        h5py = import_h5py("reading a T2 classification slice")
        with h5py.File(self.paths[index], "r") as hf:
            im = hf["reconstruction_rss"][:]
        im = im[self.slice_num[index]]
        if random.randint(0, 100) > 30 and self.aug:
            im, _ = augment_image_t2(im)
        im = center_crop_2d(im, (224, 224))
        im = normalisation_2d(im, self.norm_type)
        x = np.ascontiguousarray(im, dtype=np.float32)[None]  # (1, H, W)
        return x, np.float32(self.labels[index])


class DWISliceDataset(_BaseSheetDataset):
    """(b1500, ADC) slice pairs, 2 channels."""

    def __init__(self, datasheet, datapath, augment=False, saveims=False,
                 rundir="", istrain=True, isval=False, istest=False):
        super().__init__(datasheet, datapath, augment, istrain, isval, istest)

    def __getitem__(self, index: int):
        h5py = import_h5py("reading a DWI classification slice")
        with h5py.File(self.paths[index], "r") as f:
            b1500 = f["b1500"][:]
            adc_map = f["adc_map"][:]
        s = self.slice_num[index]
        b1500, adc_map = b1500[s], adc_map[s]
        if random.randint(0, 100) > 30 and self.aug:
            b1500, adc_map, _ = augment_image_diffusion(b1500, adc_map)
        b1500_224 = resize_2d(b1500, (224, 224), "cubic")
        adc_224 = resize_2d(adc_map, (224, 224), "cubic")
        x = np.stack([norm_b1500(b1500_224), norm_adc(adc_224)]
                     ).astype(np.float32)
        return x, np.float32(self.labels[index])

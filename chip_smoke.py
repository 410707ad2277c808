#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card and check it.

    python3 chip_smoke.py

The main path is the serving daemon's ``/v1/segment_kspace``: raw
single-coil or multi-coil k-space -> iFFT magnitude (per coil, then RSS) ->
percentile clip -> Otsu body mask (its disk(2) open/close in the CUDA kernel
``csrc/open_close.cu``, its connected components in ``csrc/label_prop.cu``)
-> resize and z-score -> ResNet34 U-Net at full width (320x320 input,
decoder 256-128-64-32-16) -> mask. The weights are random, made from a
seed.

Phases, each printing one JSON line with its seconds:
  0  setup: watchdog, the card's name and power limit, TF32 off for the
     parity phases 2-4;
  1  build the CUDA kernels with nvcc (one process a source, started
     together), with what ptxas says of them;
  2  kernel vs its plain PyTorch version on the card, bit-equal at the
     kernel's word and band edges, three densities and misaligned starts;
     at a volume's (35, 640, 368) and a served request's (8, 640, 368)
     shape its cold and warm time with the host out of the window
     (``utils/cuda_timing.py``), the host's time a call, the plain
     version's time, the four-convolution yardstick's, and the bound;
  3  the preprocess chain on a (35, 640, 368, 2) volume, card vs CPU;
  4  the model's logits on a (16, 1, 320, 320) batch, card vs CPU;
  5  the server, started from torch's own precision flags as its command
     line starts it, answering three /v1/segment_kspace requests, each
     checked against the in-process result and shown to launch each mask
     kernel (open_close, label_components) exactly once;
  6  train: pack four synthetic 35-slice volumes with the port's packer
     (one open/close launch each), train two epochs through the launcher
     at full width (batch 8, aug light, bf16 autocast and store, as the
     reference run), serve the best checkpoint back on the val volume;
     one engine step card vs CPU in f32 (loss, every gradient, the BN
     running stats); two steps with ``--remat`` on and off bit-equal, the
     BN running stats moved once a step; train slices/s at batch 8 f32, batch 8 bf16 and
     batch 128 bf16 with peak memory;
  7  evaluate and serve the rest: the batch inference CLI on phase 6's val
     list and best checkpoint with --metrics, plain and with --tta hflip;
     evaluate_volume at 35x320x320 card vs CPU (the exact EDT bit-equal,
     HD95 / ASSD against the CPU and a scipy oracle of the reference's
     medimetrics, the no-zero sentinel) and its time per volume; a daemon
     with --tta hflip --microbatch-window-ms 5 at its default batch of 16
     answering eight concurrent 6-slice /v1/segment requests (so a batch
     mixes requests) and one /v1/segment_kspace request (one open/close
     launch), with its /metricsz counts, then that burst timed five times
     each on it and on the same daemon without the window; UNet++ at full width
     (logits card vs CPU, b8 bf16 train slices/s, a checkpoint served
     back); the run report of phase 6's run directory;
  8  the rest of preprocessing: label_components (three kernels, tiled
     union-find) vs its plain sweeps, bit-equal in one wrapper call each at
     its edge cases (widths across its tiles, H = 1, a checkerboard, a
     640x368 serpentine of hundreds of plain sweeps, a comb, rings,
     borders), 20 identical calls, a call that reads nothing back, and on
     phase 3's volume's masks before their components; timed at a volume,
     a request and the serpentine beside the bound and the plain sweeps,
     and as a share of phase 3's and phase 5's preprocess; the probe's
     masked_max_prop (``tools/probe_label_prop.py``) bit-equal and timed,
     with its time split into set-up, steps and halo exchanges; a seeded
     (35, 15, 640, 368, 2) multi-coil volume card vs CPU, its card time and
     peak memory; N4 + NL-means on 4 of its slices card vs CPU, per-slice
     N4 updates compared first; one (4, 15, 640, 368, 2) multi-coil
     /v1/segment_kspace request against the in-process result, launching
     each mask kernel once;
  9  the rest of the 2-D surface, on phase 6's ``amp`` checkpoint, val list
     and packs, at full width: its bf16 logits of a (16, 1, 320, 320) batch
     card vs CPU (within 8 bf16 spacings at the largest |logit|, the CPU
     tests' bound) beside its f32 logits; the checkpoint served in bf16
     (one 8-slice /v1/segment_kspace equal to in-process, each mask kernel
     launched once); ``cli.quantize`` on it (a bfloat16 artifact); the
     int8 convolution exact at K = 3*3*768 against int64 numpy; the
     artifact's int8 logits card vs CPU, bit-equal; ``cli.infer --qtree``
     and ``--quant folded`` with --metrics beside the bf16 run's Dice; a
     ``--qtree`` daemon answering /v1/segment_kspace (each mask kernel
     once) and /v1/segment, equal to in-process, with its /metricsz; the
     16x320x320 batch timed at f32 (TF32 off), bf16, folded and int8; a
     launcher run preempted after its first chunk by ``request_preempt()``
     and resumed with --resume, its history and best.ckpt bit-equal to a
     straight run (cuDNN deterministic); a launcher run with
     --encoder-weights (a seeded torchvision ResNet34 file) whose encoder
     holds the file's weights before the first step, with
     --profile-epochs 1 leaving a trace that names CUDA kernels;
 10  the corpus route, reduced in depth: ``tools/corpus_run.py`` at the b8
     bar on 8 corpus volumes of 112x368x320 made in memory and packed on
     the card (each mask kernel launched once a pack), the launcher's split
     and one epoch at full width, ``cli.infer --metrics`` on the val list;
     val Dice, epoch seconds and slices/s, no quality gate;
 11  the 3-D patch path on phase 10's packs: ``train/trainer3d.py``'s CLI
     at the reference width (channels 32-64-128-256-320), ROI 160x160x64,
     batch 2, ``--amp``, with the host sampler and with --device-sampling;
     ``cli.infer --ckpt3d --metrics`` on a whole val volume; ms a step and
     peak memory with remat on and off; one f32 step of a narrow model card
     vs CPU (TF32 off); a narrow run preempted and resumed bit-equal to a
     straight one (cuDNN deterministic). The 3-D path launches no mask
     kernel;
 12  classical recon and the ingest route: ``t2_reconstruction`` at the
     protocol size of ``bench.py:bench_grappa`` (3 averages, 10 slices, 20
     coils, 640x368, R=3, 32 ACS lines) and ``dwi_reconstruction`` at
     ``scripts/measure_dwi.py``'s (51 averages, 8 slices, 12 coils,
     200x104, R=2; the EPI timing from an ISMRMRD header), each timed over
     2 runs after a warm-up with its peak memory, and held against the port
     on the CPU on one slice (T2: slice 0 of the card's case; DWI: every
     output map); each once more with its slices spread over ``mesh=[cuda:0,
     cuda:0]``, timed and held to the one-device output within rtol / atol
     1e-5 (the thresholded DWI maps by the share of pixels past);
     ``cli.recon --data-parallel`` with one card more than there are
     refused ("requested N devices, have M"); four pickled 35x640x368
     magnitude volumes through
     ``build_preprocess`` with ``KneePckAdapter`` (each mask kernel once a
     volume), again with ``skip_existing`` (nothing redone), and the packs
     through the slice store's native npz loader, bit-equal to
     ``np.load``; the ``.h5`` route's refusal without h5py (its message
     checked), or a fixture read where h5py is installed. The recon
     launches no mask kernel;
 13  VarNet and the recon U-Net, from torch's own precision flags: the
     VarNetArgs defaults (12 cascades, chans 18, b50: 12 coils, 3 averages,
     320x320, maps with one average, seeded random weights) forward in f32
     card vs CPU (TF32 off; gated by the CPU's own f32 distance from
     float64) and in float64; ms a bf16 training step and peak memory at
     the protocol configuration (10 cascades, chans 20, 12 coils, one
     average) and at the defaults, batch 1 and 2, one protocol step traced
     (busy share, top kernels); ``tools/varnet_synthetic.py``'s protocol
     recipe cut to 1 epoch (train loss and val NMSE / SSIM / PSNR by
     epoch); one f32 SSIM-loss step card vs CPU from that run's weights,
     the loss and every gradient against a one-ulp floor (at full width
     when the CPU's two steps stay under 20 s, else 4 cascades); a
     ``--task recon`` daemon on that run's checkpoint answering a 5-D and a
     batched 6-D ``/v1/reconstruct``, and one on a b50 checkpoint answering
     with one-average maps, each equal to the in-process runner, with
     ``/metricsz`` and no mask kernel launched; the recon U-Net at full
     width (chans 32, 4 pools, 320x320): one f32 step card vs CPU and ms a
     bf16 step; ``cli.train_varnet`` and ``cli.evaluate`` refusing without
     h5py (the message checked);
 14  the ConvNeXt classifier, from torch's own precision flags: the
     ``convnext`` (base) variant's forward at full width (1-channel stem,
     2x224x224) and tiny's with a 2-channel stem at 50x70, f32 card vs CPU
     (TF32 off; gated by the CPU's own f32 distance from float64), base in
     bf16 card vs CPU (16 bf16 spacings at the largest |logit|); ms a bf16
     train step (the AMSGrad chain of the vendored YAMLs) and peak memory
     for base and tiny (2-channel) at 224x224, batch 32, one base step
     traced (busy share, launches); one f32 step card vs CPU (the loss and
     every gradient against a one-ulp floor); ``tools/classify_synthetic.py``
     whole with its gate (best val AUC above 0.9 and early stopping fired),
     beside the JAX record; the recipe preempted after epoch 2 of 4 and
     resumed, its history and best checkpoint bit-equal to a straight run
     (cuDNN deterministic); a ``--task classify`` daemon on the recipe's
     best checkpoint answering ``/v1/classify`` equal to in-process, 400
     for a wrong channel count, 404 for the segment routes, ``/metricsz``;
     the datasheet datasets and ``cli.train_classify`` refusing without
     h5py (the message checked). No mask kernel runs;
 15  data parallelism (f32, TF32 off, cuDNN deterministic), on two volumes
     packed for it (each mask kernel once a volume):
     ``tools/probe_data_parallel.py`` on two ranks that share the card over
     gloo against one rank: one step of the ResNet34 U-Net at 320x320
     (dice_bce, light aug, global batch 8, 4 a rank; the loss, every
     gradient and the BN running statistics against a one-ulp floor; in
     float64 at a 160x160 crop, each tensor within 1e-6 of its max), the
     row-sharded store bit-equal to the replicated one, ms a step on two
     ranks and on one, ms and bytes of the gradient all-reduce,
     ``validate_volume_sharded`` against one rank, a one-epoch
     ``UNet2DTrainer`` run writing the one-rank run's files from rank 0,
     one step of ConvNeXt base (224x224, batch 32) and of the 3-D U-Net
     (reference width, ROI 160x160x64); ``tools/probe_coil_parallel.py``'s
     ``rank_main`` in the same ranks: the protocol VarNet (10 cascades,
     ``chans`` 20, 12 coils, 320x320) on a ``(1, 2)`` coil grid, one f32
     step against one rank (the loss within 1e-5, the gradients' drift
     against a coil-order floor), the same step in float64 at a 160x160
     crop (1e-10 of each tensor's max), ms a bf16 step on the grid and on
     one rank, the coil all-reduces a step and their bytes;
     ``preprocess_volumes_pairs(devices=[cuda:0, cuda:0])`` on the two
     volumes bit-equal to per-volume calls (each mask kernel once a
     volume); ``segment_volume_2d`` on devices
     ``[cuda:0, cuda:0]`` bit-equal to one device; a world-1 NCCL group
     taking one U-Net step, its ``barrier`` holding the host until the
     card's queued work has run; ``cli.launcher --data-parallel`` with one
     rank more than cards refused ("requested N devices, have M");
     ``graft_entry.dryrun_multichip(2)`` passing (its ``dryrun_rank`` and
     the probes run in the same two ranks, one spawn for all, and
     ``dryrun_check`` holds them to one device: the U-Net, the classifier,
     the one-cascade VarNet on a (1, 2) grid, the T2 recon over
     ``[cuda:0, cuda:0]``, the two-cascade VarNet pipelined over the two
     ranks and the 3-D trainer's epoch at ``spatial_parallel`` 2);
     ``tools/probe_model_parallel.py``'s parts in the same ranks: the
     reference 3-D U-Net (ROI 160x160x64, batch 2) depth-sharded over the
     two ranks (32 planes each): the f32 forward and one f32 step against
     one rank (a one-ulp floor), the step in float64 at a narrow width
     (1e-10 of each tensor's max), ms a bf16 step on the grid and on one
     rank, the halo sends and bytes, the depth all-reduces a step and the
     peak GiB a rank; ``cli.infer --ckpt3d --spatial-parallel 2``'s rank on
     phase 11's checkpoint and whole val volume, its masks against the
     one-rank CLI's away from the threshold's margin; the protocol VarNet
     over a 2-stage pipe (batch 2, two microbatches): one f32 step against
     one rank, ms a bf16 step on the pipe and one rank, the sends and bytes
     a step, the bubble share. The kernel line's ``launches_by_path`` has a
     row for the spread preprocess and one for each of the two
     point-to-point paths (no mask kernel runs on them).
Then a ``kernels`` line (each kernel's times, bound, plain version, and
the CUDA kernels a wrapper call launches, from a profiler trace), the
``nvidia-smi`` line and, last, the result line
``{"ok": true, "device": {...}}``. Any mismatch raises and the script exits
non-zero; without a card it exits non-zero and prints no result, and a
watchdog turns a hang into a non-zero exit with a traceback.
"""

from __future__ import annotations

import copy
import csv
import dataclasses
import faulthandler
import io
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from mri_acl_imagesegmentation_adsp_tpu_torch.classify.dataset import (
    DWISliceDataset, T2SliceDataset, weighted_bce_loss)
from mri_acl_imagesegmentation_adsp_tpu_torch.classify.trainer import (
    ClassifierArgs, ClassifierTrainer)
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import (
    evaluate as evaluate_cli, infer, launcher, quantize, recon as recon_cli,
    serve, train_classify, train_varnet)
from mri_acl_imagesegmentation_adsp_tpu_torch.cli.infer import (
    load_model_from_ckpt, model_apply_fn)
from mri_acl_imagesegmentation_adsp_tpu_torch import native
from mri_acl_imagesegmentation_adsp_tpu_torch.data import recon_data
from mri_acl_imagesegmentation_adsp_tpu_torch.data.adapters import (
    FastMRISinglecoilAdapter, KneePckAdapter)
from mri_acl_imagesegmentation_adsp_tpu_torch.data.hbm_loader import (
    SliceStore, gather_batch, read_list)
from mri_acl_imagesegmentation_adsp_tpu_torch.data.packer import (
    build_preprocess, pack_kspace_volume)
from mri_acl_imagesegmentation_adsp_tpu_torch.data.preprocess import (
    MRIKneePreprocessor)
from mri_acl_imagesegmentation_adsp_tpu_torch.infer.quant import (
    QuantConfig, QuantizedUNet2D, int8_conv)
from mri_acl_imagesegmentation_adsp_tpu_torch.infer.segment import (
    SURFACE_CHUNK, ReplicatedApply, evaluate_volume, segment_volume_2d,
    segment_volumes_2d, slice_metrics, threshold_probs)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.convnext import (
    ConvNeXt, init_convnext_weights)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.factory import (
    build_unet, build_unet3d)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.torch_import import (
    convert_resnet_encoder, load_torch_checkpoint)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.unet2d import (
    init_weights)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.unet3d import (
    init_weights3d)
from mri_acl_imagesegmentation_adsp_tpu_torch.native import (
    _build as native_build)
from mri_acl_imagesegmentation_adsp_tpu_torch.ops import edt
from mri_acl_imagesegmentation_adsp_tpu_torch.ops.kernels import (
    _build, components, morphology)
from mri_acl_imagesegmentation_adsp_tpu_torch.ops.maskops import (
    open_closed_otsu_mask)
from mri_acl_imagesegmentation_adsp_tpu_torch.ops.restoration import (
    n4_bias_correction)
from mri_acl_imagesegmentation_adsp_tpu_torch.recon import (
    dwi_reconstruction, t2_reconstruction)
from mri_acl_imagesegmentation_adsp_tpu_torch.report import exporter
from mri_acl_imagesegmentation_adsp_tpu_torch import graft_entry
from mri_acl_imagesegmentation_adsp_tpu_torch.parallel import mesh
from mri_acl_imagesegmentation_adsp_tpu_torch.tools import (
    classify_synthetic, corpus_run, probe_coil_parallel, probe_data_parallel,
    probe_label_prop, probe_model_parallel, probe_recon, varnet_synthetic)
from mri_acl_imagesegmentation_adsp_tpu_torch.tools.probe_train_step import (
    grads_f64)
from mri_acl_imagesegmentation_adsp_tpu_torch.train.augment import (
    augment_batch)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.fastmri_unet import (
    FastMRIUnet, init_fastmri_weights)
from mri_acl_imagesegmentation_adsp_tpu_torch.train import trainer3d
from mri_acl_imagesegmentation_adsp_tpu_torch.train.unet_recon_trainer import (
    UnetReconArgs, UnetReconTrainer, unet_transform)
from mri_acl_imagesegmentation_adsp_tpu_torch.recon.varnet import VarNet
from mri_acl_imagesegmentation_adsp_tpu_torch.train.varnet_trainer import (
    VarNetArgs, VarNetTrainer, build_varnet_from_args, varnet_loss)
from mri_acl_imagesegmentation_adsp_tpu_torch.train.checkpoint import (
    load_best, save_best)
from mri_acl_imagesegmentation_adsp_tpu_torch.train.engine import Engine
from mri_acl_imagesegmentation_adsp_tpu_torch.train.losses import (
    LossManager, dice_ce_loss_3d_binary)
from mri_acl_imagesegmentation_adsp_tpu_torch.train.optim import (
    make_optimizer)
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.cuda_timing import (
    back_to_back_ms, cuda_ms, host_us, kernel_trace)
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.device import (
    f32_on_card)
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.synthetic import (
    component_masks, synthetic_knee_volume, synthetic_kspace_pairs,
    synthetic_multicoil_kspace_pairs, torchvision_resnet_state_dict)

WATCHDOG_S = 900          # the whole run aims for well under 300 s
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOP_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
INT32_OPS_PER_S = 132 * 64 * 1.98e9  # H100 SXM: 132 SMs x 64 lanes x boost
OPS_PER_WORD = 4 * (8 + 12)  # open_close.cu: passes x (shifts + AND/OR)
EDGE_W = (1, 31, 32, 33, 63, 64, 65, 368, 369)
DENSITIES = (0.05, 0.5, 0.95)
VOLUME = (35, 640, 368)   # fastMRI knee single-coil slices x k-space H x W
SERVE_SLICES = 8
MODEL_BATCH = (16, 1, 320, 320)
LOGIT_RTOL = 1e-3          # card vs CPU f32 logits, relative to max|logit|
TENSOR_TOL = 1e-4          # card vs CPU z-scored tensor on equal-mask slices
MASK_DIFF_MAX = 1e-3       # card vs CPU body-mask pixels allowed to differ
TRAIN_VOLUMES = 4          # packed for phase 6: 3 train, 1 val at ratio 0.8
STEP_LOSS_RTOL = 1e-4      # card vs CPU one train step, f32, TF32 off
STEP_GRAD_RTOL = 1e-3      # per gradient tensor, times its max |g|
STEP_GRAD_FLOOR_X = 3.0    # or this many times f32's floor (step_parity)
STEP_GRAD_F64_RTOL = 1e-6  # the same step in float64, per tensor
STEP_BN_RTOL = 1e-5        # BN running stats, relative
THROUGHPUT = (("b8_f32", 8, False), ("b8_bf16", 8, True),
              ("b128_bf16", 128, True))
WARMUP_STEPS, TIMED_STEPS = 3, 20
RUN_FILES = ("args.json", "history_epoch.csv", "history_step.csv",
             "history.json", "summary.json", "metrics.json", "best.ckpt",
             "best.ckpt.args.json")
EVAL_SLICES = 35           # evaluate_volume on the card: a whole volume
EVAL_CPU_SLICES = 8        # of which the CPU and scipy check these
EVAL_SHIFT_PX = 3          # pred = gt shifted along W, then opened
EVAL_RTOL = 1e-6           # HD95 / ASSD card vs CPU, relative
EVAL_SCIPY_RTOL = 1e-5     # HD95 / ASSD vs the scipy oracle, relative
EVAL_TIMED_RUNS = 20
SUMMARY_KEYS = {"volume", "num_slices", "pred_path", "dice", "iou", "hd95",
                "assd"}
MICROBATCH_REQUESTS = 8    # concurrent /v1/segment requests in phase 7
MICROBATCH_SLICES = 6      # a request's slices, fewer than a batch of 16
MICROBATCH_WINDOW_MS = 5.0
MICROBATCH_BURSTS = 5      # timed bursts per window, window off and on
NEAR_THRESHOLD = 1e-5      # mask pixels this close to 0.5 may differ
UNETPP_BATCH = 4           # logits card vs CPU
COILS = 15                 # fastMRI knee multi-coil: 15 coils at 640x368
MULTICOIL_REQUEST_SLICES = 4
RESTORED_SLICES = 4        # N4 + NL-means card vs CPU on this many slices
RESTORED_TOL = 1e-3        # their z-scored tensors, times 1 + max|t|
CHAIN_RUNS = 5             # warm preprocess runs: their median is kept
KERNEL_SOURCES = ("open_close", "label_prop")
BF16_SPACINGS = 8          # bf16 card vs CPU: bf16 spacings at max |logit|
QUANT_BATCH = (16, 1, 320, 320)
QUANT_TIMED_RUNS = 10
RESUME_SAVE_STEPS = 2      # steps between the resumed run's snapshots
CORPUS_VOLUMES = 8         # phase 10: of the corpus's 125, at 112x368x320
CORPUS_EPOCHS = 1          # of the b8 bar's 2
CHANNELS_3D = (32, 64, 128, 256, 320)   # the reference 3-D U-Net
ROI_3D = (160, 160, 64)    # (Y, X, D), the reference patch
BATCH_3D = 2
TIMED_STEPS_3D = 5         # after 2 warm-up steps, remat on and off
NARROW_3D = (8, 16, 32)    # the f32 step card vs CPU and the resume check
NARROW_ROI_3D = (64, 64, 16)
STEP3D_LOSS_RTOL = 1e-5    # f32 3-D step card vs CPU, TF32 off: the loss
STEP3D_GRAD_RTOL = 1e-3    # each gradient, times its max |g|, plus ...
STEP3D_GRAD_FLOOR = 1e-5   # ... this times the net's max |g| (the conv
                           # biases ahead of a norm have zero gradients in
                           # exact arithmetic)
T2_CASE, DWI_CASE = probe_recon.T2_CASE, probe_recon.DWI_CASE
RECON_TIMED_RUNS = 2       # after one warm-up run (3 until PR 14)
RECON_REL = 1e-4           # a pixel "past": |card - CPU| > this x max|CPU|
RECON_CARD_REL = 1e-3      # card vs CPU recon, relative to max |CPU| ...
RECON_PIXELS_PAST = 1e-3   # ... or, for the thresholded DWI maps, at most
DWI_THRESHOLDED = ("adc_map", "b1500")  # this share of pixels past
RECON_MESH_TOL = 1e-5      # mesh=[cuda:0, cuda:0] vs one device: rtol and
                           # atol (JAX's _dryrun_t2_sharded_recon), the
                           # thresholded DWI maps by RECON_PIXELS_PAST
PCK_VOLUMES = 4            # pickled magnitude volumes through the ingest
PCK_VOLUME = (35, 640, 368)
VARNET_AVES = 3            # b50, the VarNetArgs defaults' b-value
VARNET_SEED = 13
VARNET_FWD_RTOL = 1e-4     # f32 forward card vs CPU, times max |CPU|,
VARNET_FWD_FLOOR_X = 10.0  # or this many times the CPU's f32-f64 distance
VARNET_F64_RTOL = 1e-9     # float64 forward card vs CPU, times max |CPU|
VARNET_STEP_CPU_S = 20.0   # the step check runs at full width when the
                           # CPU's two steps stay under this
VARNET_NARROW_CASCADES = 4
VARNET_F64_CASCADES = 2    # the float64 step: the CPU's float64 cascade
                           # costs some 5x its f32 one (phase 13's time)
VARNET_TIMING = ("protocol", "defaults")
VARNET_BATCHES = (1, 2)
VARNET_WARMUP, VARNET_TIMED = 3, 10
VARNET_SMOKE_EPOCHS = 1    # of the protocol recipe's 13 (2 until PR 14)
UNET_RECON_BATCH = 2       # 320x320 slices a recon U-Net step
CLS_SIZE = 224             # the vendored loaders' crop / resize
CLS_FWD_BATCH = 2
CLS_ODD = (50, 70)         # tiny, 2-channel stem: Flax "SAME" pads (0, 1)
CLS_FWD_RTOL = 1e-5        # f32 forward card vs CPU, times max |CPU|, or
CLS_FWD_FLOOR_X = 10.0     # this many times the CPU's f32-f64 distance
CLS_BF16_SPACINGS = 16     # bf16 card vs CPU at the largest |logit|
CLS_BATCH = 32             # the vendored DataLoaders' batch
CLS_STEP_BATCH = 2         # the f32 and float64 steps card vs CPU
CLS_WARMUP, CLS_TIMED = 3, 10
CLS_RESUME_EPOCHS, CLS_PREEMPT_AT = 4, 2
CLS_SERVE_SLICES = 6
JAX_CLASSIFY_RECORD = {"epochs_ran": 18, "best_val_auc": 1.0,
                       "wall_s": 2095.3, "platform": "cpu"}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def reset_mask_launches() -> None:
    """Every launch count of the body mask's kernels to 0."""
    morphology.LAUNCHES = 0
    components.reset_launches()


def mask_launches() -> dict:
    """The body mask's kernel launches since the last reset."""
    return {"open_close": morphology.LAUNCHES,
            "label_components": components.LAUNCHES["label_components"]}


def open_close_bound_ms(shape) -> tuple:
    """Least time for disk(2) open+close of a uint8 (S, H, W) stack on an
    H100 and what sets it: read and write each pixel once (bytes), against
    the bit-packed pass's INT32 operations, 8 funnel shifts and 12 AND/OR
    per 32-pixel word and pass, four passes (operations), at the INT32
    rate: 64 INT32 lanes an SM, half its FP32 lanes, with no FMA to count
    twice."""
    s, h, w = shape
    bytes_ms = 2 * s * h * w / HBM_BYTES_PER_S * 1e3
    ops_ms = OPS_PER_WORD * s * h * -(-w // 32) / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def conv_open_close(dev: torch.device, dtype: torch.dtype):
    """The JAX package's default formulation of disk(2) open+close
    (``ops/maskops.py``), four ``F.conv2d`` calls with the 13-tap disk: an
    erosion pads with 1 and keeps sums >= 12.5, a dilation pads with 0 and
    keeps sums > 0.5. Sums of at most 13 are exact in fp16 and f32. A
    yardstick for the kernel; the port never calls it."""
    se = torch.from_numpy(morphology.disk(2)).to(dev, dtype)[None, None]

    def erode(m):
        return (F.conv2d(F.pad(m, (2, 2, 2, 2), value=1.0), se)
                >= 12.5).to(dtype)

    def dilate(m):
        return (F.conv2d(m, se, padding=2) > 0.5).to(dtype)

    def fn(x):
        m = x.unsqueeze(1).to(dtype)
        return erode(dilate(dilate(erode(m)))).squeeze(1).to(torch.uint8)
    return fn


def _precision_flags() -> dict:
    return {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_deterministic": torch.backends.cudnn.deterministic}


def _set_precision_flags(flags: dict) -> None:
    torch.backends.cudnn.allow_tf32 = flags["cudnn_allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = flags["matmul_allow_tf32"]
    torch.backends.cudnn.deterministic = flags["cudnn_deterministic"]


def phase_setup() -> tuple:
    """Returns the card's ``nvidia-smi`` line and torch's own precision
    flags, which the serving phase restores before it starts the daemon."""
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    defaults = _precision_flags()
    # the parity phases 2-4 compare f32 on the card with f32 on the CPU
    parity = {"cudnn_allow_tf32": False, "matmul_allow_tf32": False,
              "cudnn_deterministic": True}
    _set_precision_flags(parity)
    emit({"phase": "setup", "seconds": time.perf_counter() - t0,
          "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "torch_defaults": defaults,
          "parity_phases": parity})
    return smi, defaults


def _ptxas(name: str) -> dict:
    report = _build.ptxas_report(name)
    return {"source": f"mri_acl_imagesegmentation_adsp_tpu_torch/csrc/"
                      f"{name}.cu",
            "ptxas": [{"registers": int(r), "spill_stores_bytes": int(st),
                       "spill_loads_bytes": int(ld)}
                      for st, ld, r in zip(
                          re.findall(r"(\d+) bytes spill stores", report),
                          re.findall(r"(\d+) bytes spill loads", report),
                          re.findall(r"Used (\d+) registers", report))],
            "ptxas_lines": [ln.strip() for ln in report.splitlines()
                            if "registers" in ln or "spill" in ln
                            or "Compiling" in ln]}


def phase_build() -> None:
    """One nvcc a source, all started together, then each library loaded
    and bound by its wrapper."""
    t0 = time.perf_counter()
    fresh = {n: not _build.library_path(n).exists() for n in KERNEL_SOURCES}
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for built in [pool.submit(_build.build, n) for n in KERNEL_SOURCES]:
            built.result()
    morphology.load_library()
    components.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc": fresh, "kernels": [_ptxas(n) for n in KERNEL_SOURCES]})


def edge_cases(rng) -> list:
    """``(name, mask, band_rows)`` for the kernel's word and band edges:
    every width of ``EDGE_W`` at heights 1, 2 and 640 with the wrapper's
    band choice and at R-1, R, R+1, R+9 for each band height R it can
    pick (forced), each a stack of one slice per density of ``DENSITIES``;
    (S, 640, 368) stacks for S = 1, 8, 35; and the three border cases.
    tests/test_torch_cuda.py checks the same list."""
    heights = [(1, None), (2, None), (640, None)] + [
        (r + d, r) for r in morphology.BAND_ROWS for d in (-1, 0, 1, 9)]
    cases = []
    for w in EDGE_W:
        for h, rows in heights:
            m = np.stack([rng.random((h, w)) < d for d in DENSITIES])
            cases.append((f"w{w}_h{h}_r{rows or 'auto'}", m, rows))
    for s in (1, 8, 35):
        m = np.stack([rng.random(VOLUME[1:]) < DENSITIES[i % 3]
                      for i in range(s)])
        cases.append((f"s{s}_640x368", m, None))
    single = np.zeros((2, 33, 47), bool)
    single[:, 16, 20] = True
    cases += [("ones", np.ones((2, 33, 47), bool), None),
              ("ones_volume", np.ones(VOLUME, bool), None),
              ("zeros", np.zeros((2, 33, 47), bool), None),
              ("single_pixel", single, None)]
    return cases


def check_cases(dev: torch.device, cases: list) -> int:
    """Holds the kernel bit-equal to the plain version at every case;
    returns the largest |kernel - plain| it saw (0 when all are equal)."""
    max_err = 0
    for name, m, rows in cases:
        x = torch.from_numpy(m.astype(np.uint8)).to(dev)
        got = morphology._open_close(x, rows)
        torch.cuda.synchronize()
        want = morphology.open_close_reference(x)
        err = (got.int() - want.int()).abs()
        max_err = max(max_err, int(err.max()))
        n_diff = int((err != 0).sum())
        if n_diff:
            raise AssertionError(f"open_close {name}: {n_diff} pixels "
                                 "differ from the plain version")
        if name.startswith("ones") and not bool(got.all()):
            raise AssertionError("open_close of all ones must stay all ones")
        if name in ("zeros", "single_pixel") and bool(got.any()):
            raise AssertionError(f"open_close {name} must come out empty")
    return max_err


def check_misaligned(dev: torch.device) -> None:
    """Tensors that start off a 16-byte boundary take the kernel's
    bit-stream path; they must give the same bits."""
    rng = np.random.default_rng(7)
    m = torch.from_numpy((rng.random((3, 70, 368)) < 0.5).astype(np.uint8))
    flat = torch.zeros(m.numel() + 16, dtype=torch.uint8, device=dev)
    for offset in (1, 3, 8):
        x = flat[offset:offset + m.numel()].view(m.shape)
        x.copy_(m.to(dev))
        got = morphology._open_close(x, 16)
        if not torch.equal(got, morphology.open_close_reference(x)):
            raise AssertionError(f"open_close at offset {offset} differs "
                                 "from the plain version")


def time_shape(dev: torch.device, shape, rng) -> dict:
    """The kernel, its plain version and the convolution yardstick at one
    main-path shape (a random mask of density 0.5), beside the bound. Each
    card time keeps its ``cuda_ms`` sleep and late runs under ``timers``."""
    x = torch.from_numpy((rng.random(shape) < 0.5).astype(np.uint8)).to(dev)
    want = morphology.open_close_reference(x)
    flags = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    # the yardstick gets cuDNN's fastest algorithm, not a deterministic one
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = (
        True, False)
    timers = {}
    try:
        for dtype in (torch.float16, torch.float32):
            fn = conv_open_close(dev, dtype)
            if not torch.equal(fn(x), want):
                raise AssertionError(f"conv yardstick ({dtype}) differs "
                                     "from the plain version")
            timers["conv_" + str(dtype).removeprefix("torch.")] = cuda_ms(
                lambda: fn(x), cold=True)
    finally:
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = flags
    bound_ms, bound_by = open_close_bound_ms(shape)
    kernel = lambda: morphology.open_close(x)  # noqa: E731
    timers["cold"] = cuda_ms(kernel, cold=True)
    timers["warm"] = cuda_ms(kernel, cold=False)
    timers["plain"] = cuda_ms(lambda: morphology.open_close_reference(x),
                              cold=True, iters=20)
    conv = {k: t["ms"] for k, t in timers.items() if k.startswith("conv_")}
    cold_ms = timers["cold"]["ms"]
    out = {"shape": list(shape),
           "band_rows": morphology.band_plan(shape[0], shape[1])[0],
           "cold_ms": cold_ms, "warm_ms": timers["warm"]["ms"],
           "host_us": host_us(kernel), **kernel_trace(kernel),
           "plain_ms": timers["plain"]["ms"], "conv_ms": min(conv.values()),
           "conv_dtype": min(conv, key=conv.get).removeprefix("conv_"),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_share": bound_ms / cold_ms, "timers": timers}
    if not cold_ms < out["conv_ms"]:
        raise AssertionError(f"open_close at {shape} is not faster than the "
                             f"convolution yardstick: {cold_ms} vs "
                             f"{out['conv_ms']} ms")
    return out


def phase_kernel(dev: torch.device) -> dict:
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    cases = edge_cases(rng)
    max_err = check_cases(dev, cases)
    check_misaligned(dev)
    volume = time_shape(dev, VOLUME, rng)
    served = time_shape(dev, (SERVE_SLICES,) + VOLUME[1:], rng)
    row = {"name": "open_close", "route": "cuda",
           "source": "mri_acl_imagesegmentation_adsp_tpu_torch/csrc/"
                     "open_close.cu",
           "replaces": "mri_acl_imagesegmentation_adsp_tpu/ops/pallas/"
                       "morphology.py:93",
           "launches": None, "max_abs_err": float(max_err),
           "ms": volume["cold_ms"],
           "plain_ms": volume["plain_ms"], "bound_ms": volume["bound_ms"],
           "bound_by": volume["bound_by"], "library_ms": None,
           "shape": volume["shape"], "warm_ms": volume["warm_ms"],
           "host_us": volume["host_us"], "conv_ms": volume["conv_ms"],
           "kernel_us": volume["kernel_us"],
           "kernels_per_call": volume["kernels_per_call"],
           "served_shape": {
               k: served[k] for k in ("shape", "cold_ms", "warm_ms",
                                      "host_us", "plain_ms", "conv_ms",
                                      "bound_ms", "bound_by", "kernel_us",
                                      "kernels_per_call")}}
    emit({"phase": "kernel", "seconds": time.perf_counter() - t0,
          "cases": len(cases), "bit_equal": True, "max_abs_err": max_err,
          "volume": volume, "served": served})
    return row


def phase_preprocess(dev: torch.device, shape=VOLUME) -> float:
    """Returns the card's warm seconds for the volume, the median of
    ``CHAIN_RUNS`` runs."""
    t0 = time.perf_counter()
    pair = synthetic_kspace_pairs(seed=1, s=shape[0], h=shape[1], w=shape[2])
    kw = dict(out_size=(320, 320), slice_keep=(0.0, 1.0))
    pre = MRIKneePreprocessor(device=dev, **kw)
    reset_mask_launches()
    t1 = time.perf_counter()
    got = pre.preprocess_volume_pairs(pair)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    if mask_launches() != {"open_close": 1, "label_components": 1}:
        raise AssertionError(f"the preprocess chain launched the mask "
                             f"kernels {mask_launches()} times, not once each")
    warm = []
    for _ in range(CHAIN_RUNS):
        t1 = time.perf_counter()
        pre.preprocess_volume_pairs(pair)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t1)
    warm_s = float(np.median(warm))
    t1 = time.perf_counter()
    want = MRIKneePreprocessor(device="cpu", **kw).preprocess_volume_pairs(
        pair)
    cpu_s = time.perf_counter() - t1
    emit({"phase": "preprocess", "seconds": time.perf_counter() - t0,
          "shape": list(pair.shape), "card_first_s": first_s,
          "card_warm_s": warm_s, "card_warm_runs_s": warm, "cpu_s": cpu_s,
          **compare_packs(got, want, shape[0])})
    return warm_s


def compare_packs(got: dict, want: dict, slices: int,
                  tol: float = TENSOR_TOL) -> dict:
    """A card pack against the CPU's: body masks differ in at most
    MASK_DIFF_MAX of their pixels, and on the slices whose masks agree the
    z-scored tensors within ``tol * (1 + max|t|)``."""
    g_mask, w_mask = got["mask"].cpu(), want["mask"]
    if g_mask.shape != (slices, 320, 320) or not bool(w_mask.any()):
        raise AssertionError(f"unexpected mask {tuple(g_mask.shape)}")
    n_diff = int((g_mask != w_mask).sum())
    if n_diff > MASK_DIFF_MAX * w_mask.numel():
        raise AssertionError(f"body masks differ in {n_diff} pixels")
    same = (g_mask == w_mask).flatten(1).all(dim=1)
    g_t, w_t = got["tensor"].cpu(), want["tensor"]
    if not bool(torch.isfinite(g_t).all()) or not bool(same.any()):
        raise AssertionError("non-finite tensor or no slice's masks agree")
    err = float((g_t[same] - w_t[same]).abs().max())
    if err > tol * (1.0 + float(w_t[same].abs().max())):
        raise AssertionError(f"preprocessed tensor differs by {err}")
    return {"mask_bit_equal": n_diff == 0, "mask_diff_pixels": n_diff,
            "mask_pixels": int(w_mask.numel()),
            "slices_with_equal_masks": int(same.sum()),
            "tensor_max_abs_err": err, "tensor_tol": tol}


def phase_model(dev: torch.device) -> torch.nn.Module:
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(1234)
    model = init_weights(build_unet("unet", "resnet34", in_ch=1, classes=1),
                         gen).eval()
    x = torch.randn(MODEL_BATCH, generator=gen)
    with torch.inference_mode():
        t1 = time.perf_counter()
        want = model(x)
        cpu_s = time.perf_counter() - t1
        card = copy.deepcopy(model).to(dev)
        xd = x.to(dev)
        got = card(xd).cpu()
        ms = cuda_ms(lambda: card(xd), cold=False, iters=10)["ms"]
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not bool(torch.isfinite(got).all()) or err > LOGIT_RTOL * scale:
        raise AssertionError(f"card logits differ from CPU by {err} "
                             f"(max |logit| {scale})")
    emit({"phase": "model", "seconds": time.perf_counter() - t0,
          "model": "unet/resnet34", "batch": list(MODEL_BATCH),
          "logits_max_abs_err": err, "logits_max_abs": scale,
          "tol": f"{LOGIT_RTOL} * max|logit|", "card_ms_per_batch": ms,
          "cpu_s_per_batch": cpu_s})
    return model


def _npz_bytes(compress: bool = False, **arrays) -> bytes:
    buf = io.BytesIO()
    (np.savez_compressed if compress else np.savez)(buf, **arrays)
    return buf.getvalue()


def _post(url: str, body: bytes) -> dict:
    req = urllib.request.Request(url, data=body)
    with urllib.request.urlopen(req, timeout=120) as r:
        reply = r.read()
    with np.load(io.BytesIO(reply)) as z:
        return {k: z[k] for k in z.files}


def _serve_breakdown(runner, body: bytes) -> dict:
    """Seconds of each stage of one /v1/segment_kspace request, run
    in-process with a synchronize after each device stage."""
    def timed(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t
    kpair, t_dec = timed(lambda: np.load(io.BytesIO(body))["kspace"])
    pre = runner._pres[(0.0, 1.0)]
    packed, t_pre = timed(lambda: pre.preprocess_volume_pairs(kpair))
    probs, t_model = timed(lambda: segment_volume_2d(
        runner.apply_fn, packed["tensor"], k=runner.k,
        batch_size=runner.batch_size, classes=runner.classes))
    out, t_d2h = timed(lambda: {
        "mask": threshold_probs(probs, runner.classes, 0.5).cpu().numpy(),
        "body_mask": packed["mask"].cpu().numpy()})
    _, t_enc = timed(lambda: _npz_bytes(True, **out))
    return {"decode_request": t_dec, "preprocess": t_pre, "model": t_model,
            "masks_to_host": t_d2h, "encode_response": t_enc}


def _start_server(ckpt: str | None, dev: torch.device, batch_size: int = 16,
                  **extra):
    server = serve.create_server(SimpleNamespace(
        ckpt=ckpt, host="127.0.0.1", port=0, batch_size=batch_size,
        pre_out_size="320,320", device=str(dev), **extra))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, "http://127.0.0.1:%d" % server.server_address[1]


def _stop_server(server, thread) -> None:
    server.shutdown()
    server.server_close()
    server.RequestHandlerClass.runner.close()
    thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("server thread still running after shutdown")


def phase_serve(model: torch.nn.Module, dev: torch.device, defaults: dict,
                shape=(SERVE_SLICES,) + VOLUME[1:]) -> dict:
    """The main path: returns the mask kernels' launches during the
    requests, and the in-process preprocess seconds of one request (the
    median stage times of ``CHAIN_RUNS`` in-process runs).
    It starts from torch's own precision flags, so the daemon runs with
    the settings that its command line gives it."""
    t0 = time.perf_counter()
    _set_precision_flags(defaults)
    vols = [synthetic_kspace_pairs(seed=100 + i, s=shape[0], h=shape[1],
                                   w=shape[2]) for i in range(3)]
    bodies = [_npz_bytes(kspace=v) for v in vols]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "best.ckpt")
        save_best(ckpt, model.state_dict(),
                  {"model": "unet", "encoder": "resnet34", "k": 1,
                   "classes": 1, "imagenet_norm": False})
        server, thread, url = _start_server(
            ckpt, dev, warmup_shape=f"{shape[0]},320,320")
        served_flags = _precision_flags()
        try:
            if served_flags["cudnn_allow_tf32"] or served_flags[
                    "matmul_allow_tf32"]:
                raise AssertionError(f"the daemon serves with TF32 on: "
                                     f"{served_flags}")
            with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                health = json.loads(r.read())
            if health.get("status") != "ok":
                raise AssertionError(f"healthz: {health}")
            runner = server.RequestHandlerClass.runner
            expected = [runner.segment_kspace(v, 0.5, False) for v in vols]
            latencies, in_lock = [], []
            reset_mask_launches()
            for i, (body, exp) in enumerate(zip(bodies, expected)):
                before = mask_launches()
                t1 = time.perf_counter()
                out = _post(url + "/v1/segment_kspace", body)
                latencies.append(time.perf_counter() - t1)
                in_lock.append(runner.last_latency_s)
                if any(n != before[k] + 1
                       for k, n in mask_launches().items()):
                    raise AssertionError(
                        f"request {i} launched the mask kernels "
                        f"{mask_launches()} times since {before}, not once")
                for key in ("mask", "body_mask"):
                    if (out[key].shape != (shape[0], 320, 320)
                            or out[key].dtype != np.uint8):
                        raise AssertionError(
                            f"request {i}: {key} {out[key].shape} "
                            f"{out[key].dtype}")
                    if not np.array_equal(out[key], exp[key]):
                        raise AssertionError(f"request {i}: served {key} "
                                             "differs from in-process")
                if list(out["indices"]) != list(range(shape[0])):
                    raise AssertionError(f"request {i}: {out['indices']}")
            launches = mask_launches()
            runs = [_serve_breakdown(runner, bodies[0])
                    for _ in range(CHAIN_RUNS)]
            breakdown = {k: float(np.median([r[k] for r in runs]))
                         for k in runs[0]}
        finally:
            _stop_server(server, thread)
    emit({"phase": "serve", "seconds": time.perf_counter() - t0,
          "endpoint": "/v1/segment_kspace", "requests": len(vols),
          "request_shape": list(vols[0].shape),
          "request_mb": len(bodies[0]) / 1e6, "latency_s": latencies,
          "runner_locked_s": in_lock, "breakdown_s": breakdown,
          "breakdown_runs_s": runs,
          "precision_flags": served_flags, "launches": launches})
    return launches, breakdown["preprocess"]

def _train_model(seed: int, name: str = "unet") -> torch.nn.Module:
    """The reference's model (or UNet++) at full width with seeded random
    weights."""
    return init_weights(build_unet(name, "resnet34", in_ch=1, classes=1),
                        torch.Generator().manual_seed(seed))


def _engine(model: torch.nn.Module, aug: str, amp: bool) -> Engine:
    """The reference run's loss and optimizer (lr 1e-3, wd 1e-4, clip 5)."""
    return Engine(model, LossManager(classes=1, name="dice_bce"),
                  make_optimizer(model.parameters(), 1e-3, 1e-4, 5.0),
                  classes=1, aug=aug, amp=amp)


def pack_volumes(dev: torch.device, art: str) -> dict:
    """The training path's kernels: one open/close and one
    label_components launch per packed volume, counted from 0 just before
    the packing."""
    pre = MRIKneePreprocessor(out_size=(320, 320), slice_keep=(0.3, 0.7),
                              device=dev)
    pairs = [synthetic_kspace_pairs(seed=i, s=VOLUME[0], h=VOLUME[1],
                                    w=VOLUME[2])
             for i in range(TRAIN_VOLUMES)]
    secs, slices = [], []
    reset_mask_launches()
    for i, pair in enumerate(pairs):
        t1 = time.perf_counter()
        info = pack_kspace_volume(pre, pair, os.path.join(art, f"vol{i}"))
        secs.append(time.perf_counter() - t1)
        slices.append(info["num_slices"])
    launches = mask_launches()
    if set(launches.values()) != {TRAIN_VOLUMES}:
        raise AssertionError(f"packing {TRAIN_VOLUMES} volumes launched "
                             f"the mask kernels {launches} times")
    if slices != [14] * TRAIN_VOLUMES:
        raise AssertionError(f"slices per pack {slices}, expected 14 each")
    return {"launches": launches, "pack_s": secs,
            "slices_per_volume": slices}


def train_through_launcher(dev: torch.device, tmp: str) -> dict:
    """Two epochs at the reference settings through the launcher, then the
    best checkpoint served back on the val volume."""
    run = os.path.join(tmp, "run")
    t1 = time.perf_counter()
    rc = launcher.main([
        "--skip-preprocess", "--artifact-dir", os.path.join(tmp, "art"),
        "--list-dir", os.path.join(tmp, "lists"), "--out-dir", run,
        "--epochs", "2", "--batch-size", "8", "--aug", "light",
        "--store-dtype", "bfloat16", "--device", str(dev)])
    secs = time.perf_counter() - t1
    if rc != 0:
        raise AssertionError(f"launcher returned {rc}")
    missing = [f for f in RUN_FILES if not os.path.isfile(
        os.path.join(run, f))]
    samples = sorted(f for f in os.listdir(os.path.join(run, "samples"))
                     if f.endswith(".png"))
    if missing or not samples:
        raise AssertionError(f"run dir lacks {missing or 'samples/*.png'}")
    with open(os.path.join(run, "history_step.csv"), encoding="utf-8") as f:
        losses = [float(r["train_loss_step"]) for r in csv.DictReader(f)]
    if len(losses) != 10 or not all(np.isfinite(losses)):
        raise AssertionError(f"step losses {losses}: expected 10 finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the train loss did not fall: {losses}")
    with open(os.path.join(run, "history.json"), encoding="utf-8") as f:
        history = json.load(f)
    model, _ = load_model_from_ckpt(os.path.join(run, "best.ckpt"), dev)
    with open(os.path.join(tmp, "lists", "val.txt"), encoding="utf-8") as f:
        val_npz = f.read().split()
    with np.load(val_npz[0]) as z:
        img, msk = z["img"], z["msk"]
    probs = segment_volume_2d(model, torch.from_numpy(img).to(dev),
                              batch_size=16)
    if (tuple(probs.shape) != img.shape
            or not bool(torch.isfinite(probs).all())):
        raise AssertionError(f"served probabilities {tuple(probs.shape)}")
    pred = threshold_probs(probs, 1, 0.5).cpu().numpy().astype(bool)
    inter = float((pred & (msk > 0)).sum())
    served_dice = (2 * inter + 1e-7) / (pred.sum() + (msk > 0).sum() + 1e-7)
    return {"seconds": secs, "step_losses": losses, "history": history,
            "samples": len(samples), "served_val_slices": int(img.shape[0]),
            "served_val_dice_f32": float(served_dice)}


def _one_step(model: torch.nn.Module, x: torch.Tensor, y: torch.Tensor,
              d: torch.device) -> dict:
    """One engine step (aug none, f32) of ``model`` on device ``d``: its
    loss, gradients, BN running stats and updated parameters, on the CPU."""
    model = copy.deepcopy(model).to(d)
    eng = _engine(model, "none", amp=False)
    loss, grads = eng.grads_one(x.to(d), y.to(d), None)
    eng.optimizer.step(grads)
    names = [n for n, _ in model.named_parameters()]
    return {"loss": float(loss),
            "grads": {n: g.cpu() for n, g in zip(names, grads)},
            "stats": {n: b.cpu() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))},
            "params": {n: p.detach().cpu()
                       for n, p in model.named_parameters()}}


def _rel_to_max(got: dict, want: dict) -> dict:
    """Per tensor: max |got - want| / max |want|."""
    return {n: float((got[n] - w).abs().max()) / (float(w.abs().max())
                                                  + 1e-30)
            for n, w in want.items()}


def step_parity(dev: torch.device, src: SliceStore) -> dict:
    """One engine step from the same weights and batch on the card and on
    the CPU (f32, TF32 off, cuDNN deterministic: the caller's flags).

    The loss and the BN running stats are held to STEP_LOSS_RTOL and
    STEP_BN_RTOL. A gradient tensor is held to STEP_GRAD_RTOL of its max
    |g|, or, where f32 cannot resolve that here, to STEP_GRAD_FLOOR_X
    times the floor: how far the CPU's gradients move, at worst over the
    tensors, when every input pixel moves by one f32 ulp. At the
    reference's full width from a random init the deep layers' gradients
    are sensitive enough that this floor is a few percent of a tensor's
    max. So the same step is also taken in float64 on both sides
    (``tools/probe_train_step.py:grads_f64``), where rounding cannot show,
    and its gradients are held to STEP_GRAD_F64_RTOL."""
    x = torch.from_numpy(src.images[:2, None].copy())
    y = torch.from_numpy(src.masks[:2].astype(np.uint8))
    model = _train_model(7)
    cpu_dev = torch.device("cpu")
    cpu = _one_step(model, x, y, cpu_dev)
    ulp = torch.nextafter(x, torch.where(
        torch.rand(x.shape, generator=torch.Generator().manual_seed(0))
        < 0.5, torch.inf, -torch.inf))
    moved = _one_step(model, ulp, y, cpu_dev)
    card = _one_step(model, x, y, dev)
    loss64_cpu, g64_cpu = grads_f64(model, x, y, cpu_dev)
    loss64_card, g64_card = grads_f64(model, x, y, dev)
    names = list(cpu["grads"])
    f64_rel = _rel_to_max(dict(zip(names, g64_card)),
                          dict(zip(names, g64_cpu)))
    grad_rel = _rel_to_max(card["grads"], cpu["grads"])
    floor_rel = _rel_to_max(moved["grads"], cpu["grads"])
    floor = max(floor_rel.values())
    grad_tol = max(STEP_GRAD_RTOL, STEP_GRAD_FLOOR_X * floor)
    bn_rel = _rel_to_max(card["stats"], cpu["stats"])
    dp = torch.cat([(card["params"][n] - p).abs().flatten()
                    for n, p in cpu["params"].items()])
    worst = max(grad_rel, key=grad_rel.get)
    out = {"batch": [2, 1, 320, 320], "loss_cpu": cpu["loss"],
           "loss_card": card["loss"],
           "loss_rel_err": abs(card["loss"] - cpu["loss"]) / abs(
               cpu["loss"]),
           "loss_tol": STEP_LOSS_RTOL,
           "grad_worst_rel_to_max": grad_rel[worst],
           "grad_worst_tensor": worst,
           "grad_median_rel_to_max": float(np.median(list(
               grad_rel.values()))),
           "grad_tensors": len(grad_rel),
           "grad_tensors_within_1e-3": sum(v <= STEP_GRAD_RTOL
                                           for v in grad_rel.values()),
           "grad_floor_one_ulp": floor,
           "loss_rel_one_ulp": abs(moved["loss"] - cpu["loss"]) / abs(
               cpu["loss"]),
           "grad_floor_median": float(np.median(list(floor_rel.values()))),
           "grad_tol": grad_tol,
           "f64_loss_rel_err": abs(loss64_card - loss64_cpu) / abs(
               loss64_cpu),
           "f64_grad_worst_rel_to_max": max(f64_rel.values()),
           "f64_grad_worst_tensor": max(f64_rel, key=f64_rel.get),
           "f64_grad_tol": STEP_GRAD_F64_RTOL,
           "bn_worst_rel_to_max": max(bn_rel.values()),
           "bn_worst_buffer": max(bn_rel, key=bn_rel.get),
           "bn_tol": STEP_BN_RTOL,
           "param_max_abs_diff": float(dp.max()),
           "param_share_over_1e-5": float((dp > 1e-5).float().mean())}
    if (out["loss_rel_err"] > STEP_LOSS_RTOL or grad_rel[worst] > grad_tol
            or out["f64_grad_worst_rel_to_max"] > STEP_GRAD_F64_RTOL
            or out["bn_worst_rel_to_max"] > STEP_BN_RTOL):
        raise AssertionError(f"train step card vs CPU: {out}")
    if out["param_max_abs_diff"] > 2.1e-3:  # Adam moves a step by <= lr
        raise AssertionError(f"parameters moved apart: {out}")
    return out


def remat_parity(dev: torch.device, src: SliceStore) -> dict:
    """``--remat`` on the card: two engine steps (aug none, f32) of the
    full-width U-Net at batch 8 from the same weights and batch, its blocks
    recomputed in the backward pass and not. Here the backward pass runs
    on autograd's device thread, where the recompute must still leave the
    BN running statistics alone: losses, gradients and running statistics
    bit-equal (the caller's flags: TF32 off, cuDNN deterministic), and
    every ``num_batches_tracked`` at 2."""
    x = torch.from_numpy(src.images[:8, None].copy()).to(dev)
    y = torch.from_numpy(src.masks[:8].astype(np.uint8)).to(dev)
    state = _train_model(7).state_dict()
    runs = {}
    for on in (False, True):
        model = build_unet("unet", "resnet34", in_ch=1, classes=1, remat=on)
        model.load_state_dict(state)
        eng = _engine(model.to(dev), "none", amp=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, grads = [], []
        for _ in range(2):
            loss, g = eng.grads_one(x, y, None)
            eng.optimizer.step(g)
            losses.append(loss.detach())
            grads.extend(t.detach().clone() for t in g)
        runs[on] = {"losses": losses, "grads": grads,
                    "buffers": {n: b.clone() for n, b in
                                model.named_buffers()},
                    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del model, eng
    plain, rem = runs[False], runs[True]
    tracked = {int(v) for n, v in rem["buffers"].items()
               if n.endswith("num_batches_tracked")}
    out = {"batch": [8, 1, 320, 320],
           "losses": [float(v) for v in rem["losses"]],
           "loss_max_abs_diff": max(float((a - b).abs()) for a, b in zip(
               plain["losses"], rem["losses"])),
           "grad_max_abs_diff": max(float((a - b).abs().max()) for a, b in
                                    zip(plain["grads"], rem["grads"])),
           "buffer_max_abs_diff": max(
               float((plain["buffers"][n].double() - b.double()).abs().max())
               for n, b in rem["buffers"].items()),
           "num_batches_tracked": sorted(tracked),
           "peak_gib": {"remat_off": plain["peak_gib"],
                        "remat_on": rem["peak_gib"]}}
    torch.cuda.empty_cache()
    if (tracked != {2} or out["loss_max_abs_diff"] or out["grad_max_abs_diff"]
            or out["buffer_max_abs_diff"]):
        raise AssertionError(f"remat on vs off on the card: {out}")
    return out


def train_throughput(dev: torch.device, src: SliceStore, batch: int,
                     amp: bool, model: str = "unet") -> dict:
    """Slices/s of the reference step (aug light) over TIMED_STEPS steps
    after WARMUP_STEPS, the host's per-step work in the window."""
    store = src.to_device(1, torch.bfloat16 if amp else torch.float32, dev)
    eng = _engine(_train_model(0, model).to(dev), "light", amp)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rows(steps):
        return torch.randint(0, store.num_slices, (steps, batch),
                             generator=gen, device=dev)
    eng.train_steps(store, rows(WARMUP_STEPS), gen)
    perm = rows(TIMED_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    losses = eng.train_steps(store, perm, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"non-finite loss at batch {batch}")
    return {"batch": batch, "amp_bf16": amp,
            "store_dtype": str(store.images.dtype).removeprefix("torch."),
            "slices_per_s": TIMED_STEPS * batch / secs,
            "ms_per_step": secs / TIMED_STEPS * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def train_breakdown(dev: torch.device, src: SliceStore, batch: int,
                    amp: bool, steps: int = 10) -> dict:
    """Where a step's time goes: for each stage, the card's time between
    CUDA events recorded around it and the host's time to issue it, over
    ``steps`` steps after two warm-up steps; then one validation pass over
    ``src`` and the best-checkpoint and sample writes, on the host clock
    with a synchronize."""
    store = src.to_device(1, torch.bfloat16 if amp else torch.float32, dev)
    eng = _engine(_train_model(0).to(dev), "light", amp)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = torch.randint(0, store.num_slices, (steps + 2, batch),
                         generator=gen, device=dev)
    eng.train_steps(store, rows[:2], gen)
    stages = ("gather", "augment", "forward_loss", "backward", "optimizer")
    events = [[torch.cuda.Event(enable_timing=True)
               for _ in range(len(stages) + 1)] for _ in range(steps)]
    host = dict.fromkeys(stages, 0.0)
    torch.cuda.synchronize()
    for i in range(steps):
        ev = events[i]
        ev[0].record()
        marks = [time.perf_counter()]
        x, y = gather_batch(store, rows[2 + i])
        ev[1].record()
        marks.append(time.perf_counter())
        x, y = augment_batch(x, y, gen, "light")
        ev[2].record()
        marks.append(time.perf_counter())
        eng.model.train()
        loss = eng._loss_from_logits(eng._forward(x), y)
        ev[3].record()
        marks.append(time.perf_counter())
        grads = torch.autograd.grad(loss, eng.params)
        ev[4].record()
        marks.append(time.perf_counter())
        eng.optimizer.step(list(grads))
        ev[5].record()
        marks.append(time.perf_counter())
        for j, st in enumerate(stages):
            host[st] += marks[j + 1] - marks[j]
    torch.cuda.synchronize()
    card = {st: sum(events[i][j].elapsed_time(events[i][j + 1])
                    for i in range(steps)) / steps
            for j, st in enumerate(stages)}
    t1 = time.perf_counter()
    eng.validate(store, max(1, batch // 2))
    validate_s = time.perf_counter() - t1
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        save_best(os.path.join(tmp, "best.ckpt"), eng.model.state_dict(),
                  {"model": "unet"})
        ckpt_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        eng.save_samples(store, tmp, max_samples=6)
        samples_s = time.perf_counter() - t1
    return {"batch": batch, "amp_bf16": amp, "steps": steps,
            "card_ms": card, "card_ms_step": sum(card.values()),
            "host_ms": {st: v / steps * 1e3 for st, v in host.items()},
            "host_ms_step": sum(host.values()) / steps * 1e3,
            "validate_s": validate_s, "validate_slices": store.num_slices,
            "save_best_s": ckpt_s, "save_samples_s": samples_s}


def phase_train(dev: torch.device, defaults: dict, tmp: str) -> dict:
    """The training path: returns the mask kernels' launches while packing.
    The packs, lists and run directory stay in ``tmp`` for phase 7."""
    t0 = time.perf_counter()
    _set_precision_flags(defaults)
    packed = pack_volumes(dev, os.path.join(tmp, "art"))
    trained = train_through_launcher(dev, tmp)
    with open(os.path.join(tmp, "lists", "train.txt"),
              encoding="utf-8") as f:
        src = SliceStore.from_files(f.read().split())
    timed_flags = {"cudnn_allow_tf32": False, "matmul_allow_tf32": False,
                   "cudnn_deterministic": False}
    _set_precision_flags(timed_flags)
    speed, stages = {}, {}
    for name, batch, amp in THROUGHPUT:
        speed[name] = train_throughput(dev, src, batch, amp)
        torch.cuda.empty_cache()
        stages[name] = train_breakdown(dev, src, batch, amp)
        torch.cuda.empty_cache()
    emit({"phase": "train_speed", "throughput": speed,
          "throughput_flags": timed_flags,
          "throughput_steps": {"warmup": WARMUP_STEPS,
                               "timed": TIMED_STEPS},
          "breakdown": stages})
    parity_flags = dict(timed_flags, cudnn_deterministic=True)
    _set_precision_flags(parity_flags)
    parity = step_parity(dev, src)
    remat = remat_parity(dev, src)
    _set_precision_flags(defaults)
    emit({"phase": "train", "seconds": time.perf_counter() - t0,
          "model": "unet/resnet34", "input": [1, 320, 320],
          "pack": packed, "launcher": trained,
          "train_slices": int(len(src)), "launcher_flags": defaults,
          "step_parity": parity, "step_parity_flags": parity_flags,
          "remat_parity": remat,
          "slices_per_s": {k: v["slices_per_s"] for k, v in speed.items()},
          "pack_s_per_volume": sum(packed["pack_s"]) / len(packed["pack_s"])})
    return packed["launches"]


def infer_cli(dev: torch.device, tmp: str) -> dict:
    """The batch inference CLI on phase 6's val list and best checkpoint,
    with --metrics, plain and with --tta hflip: every summary value finite,
    and seconds per volume."""
    lst = os.path.join(tmp, "lists", "val.txt")
    with open(lst, encoding="utf-8") as f:
        n_vol = len(f.read().split())
    out = {}
    for name, extra in (("plain", []), ("tta_hflip", ["--tta", "hflip"])):
        out_dir = os.path.join(tmp, "preds_" + name)
        flags = _precision_flags()
        t1 = time.perf_counter()
        rc = infer.main(["--ckpt", os.path.join(tmp, "run", "best.ckpt"),
                         "--list", lst, "--out-dir", out_dir, "--metrics",
                         "--device", str(dev), *extra])
        secs = time.perf_counter() - t1
        if _precision_flags() != flags:
            raise AssertionError(f"infer {name} left the precision flags "
                                 f"changed: {_precision_flags()}")
        with open(os.path.join(out_dir, "summary.json"),
                  encoding="utf-8") as f:
            summary = json.load(f)
        if rc != 0 or len(summary) != n_vol:
            raise AssertionError(f"infer {name}: rc {rc}, {summary}")
        for entry in summary:
            pred = np.load(entry["pred_path"])
            if (set(entry) != SUMMARY_KEYS or pred.dtype != np.uint8
                    or pred.shape[0] != entry["num_slices"]
                    or not all(np.isfinite(entry[k]) for k in
                               ("dice", "iou", "hd95", "assd"))):
                raise AssertionError(f"infer {name}: {entry}")
        out[name] = {"s_per_volume": secs / n_vol, "volumes": n_vol,
                     "summary": [{k: v for k, v in e.items()
                                  if k not in ("volume", "pred_path")}
                                 for e in summary]}
    return out


def scipy_hd95_assd(pred: np.ndarray, gt: np.ndarray) -> tuple:
    """The reference's medimetrics HD95 and ASSD of one slice, by scipy:
    the border is ``a ^ (edt(~a) > 0 & a)`` (the whole mask), distances
    from each mask's pixels to the other's nearest, both ways."""
    from scipy.ndimage import distance_transform_edt as np_edt
    a, b = pred.astype(bool), gt.astype(bool)
    a_border = a ^ np.logical_and(np_edt(~a) > 0, a)
    b_border = b ^ np.logical_and(np_edt(~b) > 0, b)
    a_border = a_border if a_border.any() else a
    b_border = b_border if b_border.any() else b
    d = np.concatenate([np_edt(~b)[a_border], np_edt(~a)[b_border]])
    if d.size == 0:
        return 0.0, 0.0
    return float(np.percentile(d, 95)), float(d.mean())


def _rel_err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)
                        / np.maximum(np.abs(want), 1e-30)))


def evaluate_card_vs_cpu(dev: torch.device, tmp: str) -> dict:
    """evaluate_volume at EVAL_SLICES x 320 x 320: gt is the val pack's body
    mask tiled to EVAL_SLICES slices, pred the same shifted EVAL_SHIFT_PX
    along W and opened with disk(2) by the port's plain morphology."""
    with open(os.path.join(tmp, "lists", "val.txt"), encoding="utf-8") as f:
        with np.load(f.read().split()[0]) as z:
            msk = z["msk"].astype(np.uint8)
    reps = -(-EVAL_SLICES // msk.shape[0])
    gt = np.concatenate([msk] * reps)[:EVAL_SLICES]
    shifted = np.zeros_like(gt)
    shifted[..., EVAL_SHIFT_PX:] = gt[..., :-EVAL_SHIFT_PX]
    pred = morphology.binary_opening(torch.from_numpy(shifted),
                                     morphology.disk(2)).to(torch.uint8)
    gt_t = torch.from_numpy(gt)
    pred_d, gt_d = pred.to(dev), gt_t.to(dev)
    n = EVAL_CPU_SLICES

    # the exact EDT of the largest mask's background, and the no-zero
    # sentinel: an empty prediction is H + W from every gt pixel
    k = int(gt.sum(axis=(1, 2)).argmax())
    edt_cpu = edt.edt(gt_t[k] == 0)
    edt_card = edt.edt(gt_d[k] == 0).cpu()
    ones = torch.ones(1, 320, 320, dtype=torch.uint8)
    sentinel = edt.edt(ones.to(dev)).cpu()
    empty_hd = edt.hd95_assd(torch.zeros_like(gt_d[k:k + 1]), gt_d[k:k + 1])
    empty_hd_cpu = edt.hd95_assd(torch.zeros_like(gt_t[k:k + 1]),
                                 gt_t[k:k + 1])
    if not torch.equal(edt_card, edt_cpu):
        raise AssertionError("the EDT differs card vs CPU: max "
                             f"{float((edt_card - edt_cpu).abs().max())}")
    if not (torch.equal(sentinel, torch.full_like(sentinel, 640.0))
            and float(empty_hd[0]) == float(empty_hd_cpu[0]) == 640.0):
        raise AssertionError("the no-zero sentinel is not H + W = 640")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    first = evaluate_volume(pred_d, gt_d)
    first_s = time.perf_counter() - t1
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    t1 = time.perf_counter()
    evaluate_volume(pred_d, gt_d)
    warm_s = time.perf_counter() - t1
    per_card = slice_metrics(pred_d, gt_d).cpu().numpy()
    per_cpu = slice_metrics(pred[:n], gt_t[:n]).numpy()
    oracle = np.array([scipy_hd95_assd(pred[i].numpy(), gt[i])
                       for i in range(n)])
    errs = {"dice_iou_vs_cpu": _rel_err(per_card[:n, :2], per_cpu[:, :2]),
            "hd95_assd_vs_cpu": _rel_err(per_card[:n, 2:], per_cpu[:, 2:]),
            "hd95_assd_vs_scipy": _rel_err(per_card[:n, 2:], oracle)}
    if (errs["dice_iou_vs_cpu"] > EVAL_RTOL
            or errs["hd95_assd_vs_cpu"] > EVAL_RTOL
            or errs["hd95_assd_vs_scipy"] > EVAL_SCIPY_RTOL):
        raise AssertionError(f"evaluate_volume card vs CPU / scipy: {errs}")
    if not all(np.isfinite(list(first.values()))) or first["assd"] <= 0:
        raise AssertionError(f"evaluate_volume: {first}")
    timers = {"cold": cuda_ms(lambda: slice_metrics(pred_d, gt_d), cold=True,
                              iters=EVAL_TIMED_RUNS),
              "warm": cuda_ms(lambda: slice_metrics(pred_d, gt_d),
                              cold=False, iters=EVAL_TIMED_RUNS)}
    # one 8-slice chunk's parts: an exact EDT, the sort of its distances,
    # and the chunk's HD95 and ASSD with both transforms
    c = SURFACE_CHUNK
    dist = torch.where(pred_d[:c].flatten(1) > 0,
                       edt.edt(gt_d[:c] == 0).flatten(1), torch.inf)
    dist = torch.cat([dist, dist], dim=1)
    parts = {"edt": cuda_ms(lambda: edt.edt(gt_d[:c] == 0), cold=False,
                            iters=EVAL_TIMED_RUNS),
             "sort": cuda_ms(lambda: torch.sort(dist, dim=-1), cold=False,
                             iters=EVAL_TIMED_RUNS),
             "hd95_assd": cuda_ms(lambda: edt.hd95_assd(pred_d[:c], gt_d[:c]),
                                  cold=False, iters=EVAL_TIMED_RUNS)}
    if any(t["late_runs"] for t in (*timers.values(), *parts.values())):
        raise AssertionError(f"evaluate_volume timing held host time: "
                             f"{timers}, {parts}")
    return {"shape": list(gt.shape), "metrics": first,
            "cpu_checked_slices": n, "errors": errs,
            "tolerances": {"vs_cpu": EVAL_RTOL, "vs_scipy": EVAL_SCIPY_RTOL},
            "edt_bit_equal": True, "sentinel": 640.0,
            "card_ms_per_volume": {k: t["ms"] for k, t in timers.items()},
            "card_ms_per_8_slice_chunk": {k: t["ms"] for k, t in
                                          parts.items()},
            "timers": timers, "host_s_first_call": first_s,
            "host_s_warm_call": warm_s, "peak_gib": peak_gib}


def _check_masks(got: np.ndarray, probs: torch.Tensor, what: str) -> dict:
    """Served masks against in-process probabilities: equal except where
    the probability lies within NEAR_THRESHOLD of 0.5. Returns the count of
    pixels that near and of all pixels that differ."""
    p = probs[:, 0].cpu().numpy()
    near = np.abs(p - 0.5) < NEAR_THRESHOLD
    want = (p > 0.5).astype(np.uint8)
    if got.shape != p.shape or not np.array_equal(got[~near], want[~near]):
        raise AssertionError(f"{what}: served masks differ from in-process")
    return {"near": int(near.sum()), "differ": int((got != want).sum())}


def _metricsz(url: str) -> dict:
    with urllib.request.urlopen(url + "/metricsz", timeout=30) as r:
        text = r.read().decode()
    return {ln.split()[0]: float(ln.split()[1]) for ln in text.splitlines()
            if not ln.startswith("#")}


def _burst(url: str, vols: list) -> tuple:
    """One concurrent /v1/segment request per volume: ``(wall seconds of
    the burst, each request's seconds, the replies)``."""
    replies, latency, errors = [None] * len(vols), [0.0] * len(vols), []
    bodies = [_npz_bytes(img=v) for v in vols]

    def client(i):
        t = time.perf_counter()
        try:
            replies[i] = _post(url + "/v1/segment", bodies[i])
        except Exception as exc:            # noqa: BLE001
            errors.append(f"{i}: {exc!r}")
        latency[i] = time.perf_counter() - t
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(vols))]
    t1 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    burst_s = time.perf_counter() - t1
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent requests failed: {errors}")
    return burst_s, latency, replies


def serve_tta_microbatched(model: torch.nn.Module, dev: torch.device,
                           tmp: str) -> dict:
    """Phase 4's model behind a daemon with --tta hflip, its default batch
    of 16 and a 5 ms micro-batching window: MICROBATCH_REQUESTS concurrent
    /v1/segment requests of MICROBATCH_SLICES packed slices each, so that
    a group's batches mix slices of several requests, then one
    /v1/segment_kspace and the /metricsz counts. Then the same daemon
    without the window beside it, and bursts timed on each in turn.

    On the card a slice's f32 logits move with the size of the batch it
    runs in (cuDNN picks its algorithm by shape), so the grouped masks are
    held to in-process ``segment_volumes_2d`` over the groups that the
    dispatcher formed, recorded as it runs; how far they lie from the
    per-request masks is reported."""
    ckpt = os.path.join(tmp, "phase4.ckpt")
    save_best(ckpt, model.state_dict(),
              {"model": "unet", "encoder": "resnet34", "k": 1, "classes": 1,
               "imagenet_norm": False})
    vols = []
    for i in range(TRAIN_VOLUMES):
        with np.load(os.path.join(tmp, "art", f"vol{i}", "volume.npz")) as z:
            img = z["img"][:, 0]
        vols += [img[:MICROBATCH_SLICES], img[-MICROBATCH_SLICES:]]
    vols = vols[:MICROBATCH_REQUESTS]
    kpair = synthetic_kspace_pairs(seed=300, s=SERVE_SLICES, h=VOLUME[1],
                                   w=VOLUME[2])
    warm = f"{MICROBATCH_SLICES},320,320"
    server, thread, url = _start_server(
        ckpt, dev, warmup_shape=warm, tta="hflip",
        microbatch_window_ms=MICROBATCH_WINDOW_MS)
    runner = server.RequestHandlerClass.runner
    groups = []
    served_many = runner.segment_many

    def recording(group, thr=None):
        groups.append([np.array(v) for v in group])
        return served_many(group, thr)
    try:
        runner.segment_many = recording
        try:
            burst_s, _, replies = _burst(url, vols)
        finally:
            del runner.segment_many
        local, _ = load_model_from_ckpt(ckpt, dev)
        grouped = [None] * len(vols)
        for group in groups:
            outs = segment_volumes_2d(
                local, [torch.from_numpy(v).to(dev) for v in group],
                tta="hflip")
            for v, p in zip(group, outs):
                i = next(j for j, w in enumerate(vols)
                         if np.array_equal(v, w))
                if grouped[i] is not None:
                    raise AssertionError(f"request {i} ran in two groups")
                grouped[i] = p
        if any(p is None for p in grouped):
            raise AssertionError("a request ran in no group")
        near = [_check_masks(r["mask"], p, f"micro-batched request {i}")
                for i, (r, p) in enumerate(zip(replies, grouped))]
        # per volume, as a request without micro-batching runs it
        probs = [segment_volume_2d(local, torch.from_numpy(v).to(dev),
                                   tta="hflip") for v in vols]
        vs_request = _mask_margin(replies, probs)
        before = mask_launches()
        kreply = _post(url + "/v1/segment_kspace", _npz_bytes(kspace=kpair))
        kspace_launches = {k: n - before[k]
                           for k, n in mask_launches().items()}
        if (set(kspace_launches.values()) != {1}
                or kreply["mask"].shape != (SERVE_SLICES, 320, 320)):
            raise AssertionError(f"/v1/segment_kspace launched the mask "
                                 f"kernels {kspace_launches} times")
        metrics = _metricsz(url)
        if (metrics["serve_requests_total"] != len(vols) + 1
                or metrics["serve_errors_total"] != 0):
            raise AssertionError(f"/metricsz: {metrics}")
        timing = time_microbatching(ckpt, dev, url, vols, probs)
    finally:
        _stop_server(server, thread)
    return {"requests": len(vols), "slices_per_request": [
                int(v.shape[0]) for v in vols], "batch_size": 16,
            "group_sizes": [len(g) for g in groups],
            "first_burst_s": burst_s,
            "mask_pixels": int(sum(v.size for v in vols)),
            "near_threshold_and_differing_pixels": near,
            "vs_per_request": vs_request,
            "kspace_launches": kspace_launches, "metricsz": metrics,
            "timed": timing}


def _mask_margin(replies: list, probs: list) -> dict:
    """Served masks against per-request probabilities: the pixels that
    differ, and the largest distance from 0.5 of the probability at one."""
    differ, margin = 0, 0.0
    for r, p in zip(replies, probs):
        p = p[:, 0].cpu().numpy()
        bad = r["mask"] != (p > 0.5)
        differ += int(bad.sum())
        if bad.any():
            margin = max(margin, float(np.abs(p - 0.5)[bad].max()))
    return {"differ": differ, "max_abs_p_minus_half": margin}


def time_microbatching(ckpt: str, dev: torch.device, url_on: str,
                       vols: list, probs: list) -> dict:
    """The burst on a daemon without the window (each request its own
    batch, queued on the device lock) and on the one with it, in turn,
    MICROBATCH_BURSTS times each after one untimed burst on the new
    daemon, whose masks are checked too."""
    server, thread, url_off = _start_server(
        ckpt, dev, warmup_shape=f"{MICROBATCH_SLICES},320,320", tta="hflip")
    out = {"window_ms": {"off": 0.0, "on": MICROBATCH_WINDOW_MS},
           "burst_s": {"off": [], "on": []},
           "mean_request_s": {"off": [], "on": []},
           "max_request_s": {"off": [], "on": []}}
    try:
        _, _, replies = _burst(url_off, vols)
        out["unbatched_near_threshold_and_differing_pixels"] = [
            _check_masks(r["mask"], p, f"request {i} without the window")
            for i, (r, p) in enumerate(zip(replies, probs))]
        for _ in range(MICROBATCH_BURSTS):
            for key, url in (("off", url_off), ("on", url_on)):
                burst_s, lat, _ = _burst(url, vols)
                out["burst_s"][key].append(burst_s)
                out["mean_request_s"][key].append(float(np.mean(lat)))
                out["max_request_s"][key].append(max(lat))
    finally:
        # the daemons put the precision flags back in the reverse order of
        # their start
        _stop_server(server, thread)
    out["median_burst_s"] = {k: float(np.median(v))
                             for k, v in out["burst_s"].items()}
    return out


def unetpp_full_width(dev: torch.device, src: SliceStore, tmp: str) -> dict:
    """UNet++ (resnet34, decoder 256-128-64-32-16, 320^2, one class): eval
    logits card vs CPU (TF32 off), b8 bf16 train slices/s, and one
    checkpoint served back over /v1/segment."""
    model = _train_model(11, "unetpp").eval()
    x = torch.randn((UNETPP_BATCH, 1, 320, 320),
                    generator=torch.Generator().manual_seed(5))
    flags = _precision_flags()
    _set_precision_flags({"cudnn_allow_tf32": False,
                          "matmul_allow_tf32": False,
                          "cudnn_deterministic": True})
    try:
        with torch.inference_mode():
            want = model(x)
            card = copy.deepcopy(model).to(dev)
            got = card(x.to(dev)).cpu()
    finally:
        _set_precision_flags(flags)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not bool(torch.isfinite(got).all()) or err > LOGIT_RTOL * scale:
        raise AssertionError(f"UNet++ card logits differ from CPU by {err} "
                             f"(max |logit| {scale})")
    del card
    torch.cuda.empty_cache()
    _set_precision_flags({"cudnn_allow_tf32": False,
                          "matmul_allow_tf32": False,
                          "cudnn_deterministic": False})
    try:
        speed = train_throughput(dev, src, 8, True, model="unetpp")
    finally:
        _set_precision_flags(flags)
    torch.cuda.empty_cache()
    ckpt = os.path.join(tmp, "unetpp.ckpt")
    save_best(ckpt, model.state_dict(),
              {"model": "unetpp", "encoder": "resnet34", "k": 1,
               "classes": 1, "imagenet_norm": False})
    vol = src.images[:SERVE_SLICES]
    server, thread, url = _start_server(ckpt, dev)
    try:
        reply = _post(url + "/v1/segment", _npz_bytes(img=vol))
        local, _ = load_model_from_ckpt(ckpt, dev)
        near = _check_masks(reply["mask"], segment_volume_2d(
            local, torch.from_numpy(vol).to(dev), batch_size=16),
            "UNet++ request")
    finally:
        _stop_server(server, thread)
    return {"model": "unetpp/resnet34", "decoder": [256, 128, 64, 32, 16],
            "logits_batch": [UNETPP_BATCH, 1, 320, 320],
            "logits_max_abs_err": err, "logits_max_abs": scale,
            "tol": f"{LOGIT_RTOL} * max|logit|", "train_b8_bf16": speed,
            "served_slices": int(vol.shape[0]),
            "served_near_threshold_and_differing_pixels": near}


def run_report(tmp: str) -> dict:
    run = os.path.join(tmp, "run")
    if exporter.main(["--run-dir", run]) != 0:
        raise AssertionError("the report exporter failed")
    with open(os.path.join(run, "report_metrics.json"),
              encoding="utf-8") as f:
        metrics = json.load(f)
    size = os.path.getsize(os.path.join(run, "report.html"))
    if metrics["epochs"] != 2 or size < 1000:
        raise AssertionError(f"report: {metrics}, {size} bytes")
    return {"report_html_bytes": size, "report_metrics": metrics}


def phase_evaluate(model: torch.nn.Module, dev: torch.device,
                   defaults: dict, tmp: str) -> dict:
    """Phase 7: returns the mask kernels' launches on its path (the one
    /v1/segment_kspace request), counted from 0 at its start."""
    t0 = time.perf_counter()
    _set_precision_flags(defaults)
    with open(os.path.join(tmp, "lists", "train.txt"),
              encoding="utf-8") as f:
        src = SliceStore.from_files(f.read().split())
    reset_mask_launches()
    out = {"infer_cli": infer_cli(dev, tmp),
           "evaluate_volume": evaluate_card_vs_cpu(dev, tmp),
           "serve_tta_microbatched": serve_tta_microbatched(model, dev, tmp),
           "unetpp": unetpp_full_width(dev, src, tmp),
           "report": run_report(tmp)}
    launches = mask_launches()
    if _precision_flags() != defaults:
        raise AssertionError(f"phase 7 left the precision flags changed: "
                             f"{_precision_flags()}, not {defaults}")
    emit({"phase": "evaluate", "seconds": time.perf_counter() - t0, **out,
          "launches": launches})
    return launches


# --------------------------------------------------------------------------
# Phase 8: the rest of preprocessing
# --------------------------------------------------------------------------

CC_OPS_PER_PIXEL = 12     # a pass joining each pixel to its 4 neighbours:
                          # 4 x (a test, a min, an index step)
CC_REPEATS = 20           # identical calls: the atomics' order must not show


def label_components_bound_ms(shape) -> tuple:
    """Least time for the labels of a uint8 (S, H, W) stack on an H100 and
    what sets it: read the mask and write the int32 labels once (bytes),
    against one pass of integer operations over every pixel at the INT32
    rate. How far a mask's minima travel is a cost of an algorithm, not of
    the function."""
    s, h, w = shape
    bytes_ms = 5 * s * h * w / HBM_BYTES_PER_S * 1e3
    ops_ms = CC_OPS_PER_PIXEL * s * h * w / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def masks_before_components(pair: np.ndarray,
                            dev: torch.device) -> torch.Tensor:
    """The body masks of a k-space volume as the chain makes them, before
    their connected components: uint8 (S, H, W) on ``dev``."""
    pre = MRIKneePreprocessor(device=dev)
    return open_closed_otsu_mask(*pre._clip(pre._upload(pair), True))[0]


def check_labels(m: torch.Tensor, name: str) -> torch.Tensor:
    """label_components on the card against its plain sweeps, bit-equal, in
    one wrapper call; returns the sweeps each slice takes in the plain
    version."""
    before = components.LAUNCHES["label_components"]
    got = components.label_components(m)
    torch.cuda.synchronize()
    if components.LAUNCHES["label_components"] != before + 1:
        raise AssertionError(f"label_components {name}: not one launch")
    want, sweeps = components.label_components_reference(m,
                                                         return_sweeps=True)
    n_diff = int((got != want).sum())
    if n_diff or got.dtype != torch.int32:
        raise AssertionError(f"label_components {name}: {n_diff} labels "
                             f"differ from the plain sweeps ({got.dtype})")
    return sweeps.cpu()


def time_labels(m: torch.Tensor) -> dict:
    """The kernels cold and warm, each CUDA kernel a call launches (warm,
    from a profiler trace), the plain sweeps by the host clock (they read a
    flag back each sweep) and the sweeps they take, and the function's
    bound."""
    sweeps = check_labels(m, f"timed {tuple(m.shape)}")
    kernel = lambda: components.label_components(m)  # noqa: E731
    timers = {"cold": cuda_ms(kernel, cold=True),
              "warm": cuda_ms(kernel, cold=False)}
    bound_ms, bound_by = label_components_bound_ms(tuple(m.shape))
    return {"shape": list(m.shape), "cold_ms": timers["cold"]["ms"],
            "warm_ms": timers["warm"]["ms"], "host_us": host_us(kernel),
            **kernel_trace(kernel),
            "plain_ms": probe_label_prop.host_ms(
                lambda: components.label_components_reference(m)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / timers["cold"]["ms"],
            "plain_sweeps": sweeps.tolist(), "timers": timers}


def repeat_and_sync_checks(dev: torch.device) -> dict:
    """``CC_REPEATS`` calls on one random (8, 640, 368) stack give the same
    labels, those of the plain sweeps; and a call under
    ``torch.cuda.set_sync_debug_mode("error")`` reads nothing back."""
    m = torch.from_numpy((np.random.default_rng(5).random(
        (SERVE_SLICES,) + VOLUME[1:]) < 0.6).astype(np.uint8)).to(dev)
    first = components.label_components(m)
    check_labels(m, "random request stack")
    for i in range(CC_REPEATS - 1):
        if not torch.equal(components.label_components(m), first):
            raise AssertionError(f"label_components call {i + 2} of "
                                 f"{CC_REPEATS} differs from the first")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        components.label_components(m)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return {"repeats": CC_REPEATS, "identical": True,
            "no_sync_in_wrapper": True}


def label_components_checks(dev: torch.device) -> dict:
    """Edge cases, repeated calls, phase 3's masks before their components,
    and the times at a volume (phase 3's) and a request (phase 5's
    first)."""
    cases = component_masks(np.random.default_rng(0))
    edge = {}
    for name, m in cases:
        sweeps = check_labels(torch.from_numpy(m.astype(np.uint8)).to(dev),
                              name)
        edge[name] = int(sweeps.max())
    if edge["maze"] < 300:
        raise AssertionError(f"the serpentine took {edge['maze']} plain "
                             "sweeps")
    repeats = repeat_and_sync_checks(dev)
    volume = masks_before_components(synthetic_kspace_pairs(
        seed=1, s=VOLUME[0], h=VOLUME[1], w=VOLUME[2]), dev)
    request = masks_before_components(synthetic_kspace_pairs(
        seed=100, s=SERVE_SLICES, h=VOLUME[1], w=VOLUME[2]), dev)
    maze = torch.from_numpy(dict(cases)["maze"].astype(np.uint8)).to(dev)
    return {"cases": len(cases), "max_plain_sweeps_by_case": edge,
            "bit_equal": True, **repeats, "volume": time_labels(volume),
            "served": time_labels(request), "maze": time_labels(maze)}


def multicoil_volume(dev: torch.device, pair: np.ndarray) -> dict:
    """A (35, 15, 640, 368, 2) volume through preprocess_volume_pairs,
    card against CPU; the card's first and warm seconds and peak memory."""
    kw = dict(out_size=(320, 320), slice_keep=(0.0, 1.0))
    pre = MRIKneePreprocessor(device=dev, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    got = pre.preprocess_volume_pairs(pair)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() - base
    warm = []
    for _ in range(3):
        t1 = time.perf_counter()
        pre.preprocess_volume_pairs(pair)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t1)
    t1 = time.perf_counter()
    want = MRIKneePreprocessor(device="cpu", **kw).preprocess_volume_pairs(
        pair)
    cpu_s = time.perf_counter() - t1
    return {"shape": list(pair.shape), "card_first_s": first_s,
            "card_warm_s": warm, "peak_gib_above_start": peak / 2 ** 30,
            "cpu_s": cpu_s, **compare_packs(got, want, pair.shape[0])}


def restored_slices(dev: torch.device, pair: np.ndarray) -> dict:
    """The chain with N4 and NL-means on, card against CPU: first each
    slice's N4 updates per level on the chain's own clipped image and body
    mask, then the packs; tensors are held on the slices whose updates and
    masks agree."""
    kw = dict(out_size=(320, 320), slice_keep=(0.0, 1.0), use_n4=True,
              use_denoise=True)
    card = MRIKneePreprocessor(device=dev, **kw)
    cpu = MRIKneePreprocessor(device="cpu", **kw)
    iters = []
    for pre in (card, cpu):
        img, mk = pre._clip_and_mask(pre._upload(pair), True)
        iters.append(n4_bias_correction(img, mk, return_iterations=True
                                        )[1].cpu())
    same_iters = (iters[0] == iters[1]).all(dim=1)
    if not bool(same_iters.any()):
        raise AssertionError(f"N4 updates differ in every slice: {iters}")
    t1 = time.perf_counter()
    got = card.preprocess_volume_pairs(pair)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    want = cpu.preprocess_volume_pairs(pair)
    cpu_s = time.perf_counter() - t1
    keep = {k: got[k][same_iters.to(dev)] for k in ("mask", "tensor")}
    held = compare_packs(keep, {k: want[k][same_iters] for k in keep},
                         int(same_iters.sum()), RESTORED_TOL)
    return {"shape": list(pair.shape), "n4_updates_card": iters[0].tolist(),
            "n4_updates_cpu": iters[1].tolist(),
            "slices_with_equal_updates": int(same_iters.sum()),
            "card_s": card_s, "cpu_s": cpu_s, **held}


def multicoil_request(model: torch.nn.Module, dev: torch.device) -> dict:
    """One multi-coil /v1/segment_kspace request against the in-process
    result: returns its reply's check and the mask kernels' launches, counted
    from 0 just before it."""
    kpair = synthetic_multicoil_kspace_pairs(
        seed=3, s=MULTICOIL_REQUEST_SLICES, c=COILS, h=VOLUME[1], w=VOLUME[2])
    body = _npz_bytes(kspace=kpair)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "best.ckpt")
        save_best(ckpt, model.state_dict(),
                  {"model": "unet", "encoder": "resnet34", "k": 1,
                   "classes": 1, "imagenet_norm": False})
        server, thread, url = _start_server(ckpt, dev)
        try:
            expected = server.RequestHandlerClass.runner.segment_kspace(
                kpair, 0.5, False)
            reset_mask_launches()
            t1 = time.perf_counter()
            out = _post(url + "/v1/segment_kspace", body)
            latency = time.perf_counter() - t1
            launches = mask_launches()
        finally:
            _stop_server(server, thread)
    if set(launches.values()) != {1}:
        raise AssertionError(f"the multi-coil request launched the mask "
                             f"kernels {launches} times, not once each")
    for key in ("mask", "body_mask"):
        if (out[key].shape != (MULTICOIL_REQUEST_SLICES, 320, 320)
                or not np.array_equal(out[key], expected[key])):
            raise AssertionError(f"served multi-coil {key} differs from "
                                 "in-process")
    if not out["body_mask"].any():
        raise AssertionError("the multi-coil request's body masks are empty")
    return {"request_shape": list(kpair.shape), "request_mb": len(body) / 1e6,
            "latency_s": latency, "launches": launches}


def phase_preprocess_rest(model: torch.nn.Module, dev: torch.device,
                          defaults: dict, chain_s: dict) -> tuple:
    """Phase 8: returns the kernels-line rows of label_components and
    masked_max_prop, and the mask kernels' launches on the multi-coil
    request. ``chain_s`` holds phase 3's warm preprocess seconds of a
    volume and phase 5's in-process preprocess seconds of a request, of
    which the labels' warm time is reported as a share."""
    t0 = time.perf_counter()
    f32 = {"cudnn_allow_tf32": False, "matmul_allow_tf32": False,
           "cudnn_deterministic": True}
    _set_precision_flags(f32)   # the chains card vs CPU in f32
    cc = label_components_checks(dev)
    share = {**chain_s,
             "labels_share_of_volume": cc["volume"]["warm_ms"] * 1e-3
             / chain_s["preprocess_volume_warm_s"],
             "labels_share_of_request": cc["served"]["warm_ms"] * 1e-3
             / chain_s["preprocess_request_s"]}
    components.reset_launches()
    probe = probe_label_prop.probe(dev)
    probe_launches = components.LAUNCHES["masked_max_prop"]
    if probe_launches < 1:
        raise AssertionError("the probe launched masked_max_prop no time")
    pair = synthetic_multicoil_kspace_pairs(seed=2, s=VOLUME[0], c=COILS,
                                            h=VOLUME[1], w=VOLUME[2])
    volume = multicoil_volume(dev, pair)
    mid = (pair.shape[0] - RESTORED_SLICES) // 2
    restored = restored_slices(dev, pair[mid:mid + RESTORED_SLICES])
    del pair
    _set_precision_flags(defaults)
    request = multicoil_request(model, dev)
    emit({"phase": "preprocess_rest", "seconds": time.perf_counter() - t0,
          "chain_flags": f32, "label_components": cc,
          "body_mask_share": share, "masked_max_prop": probe,
          "multicoil_volume": volume, "n4_nl_means": restored,
          "multicoil_request": request})
    source = "mri_acl_imagesegmentation_adsp_tpu_torch/csrc/label_prop.cu"
    replaces = "scripts/probe_pallas_roll.py:50"
    keys = ("shape", "cold_ms", "warm_ms", "host_us", "plain_ms", "bound_ms",
            "bound_by", "kernel_us", "kernels_per_call")
    cc_row = {"name": "label_components", "route": "cuda", "source": source,
              "replaces": replaces, "launches": None, "max_abs_err": 0.0,
              "ms": cc["volume"]["cold_ms"],
              "plain_ms": cc["volume"]["plain_ms"],
              "bound_ms": cc["volume"]["bound_ms"],
              "bound_by": cc["volume"]["bound_by"], "library_ms": None,
              "shape": cc["volume"]["shape"],
              "warm_ms": cc["volume"]["warm_ms"],
              "host_us": cc["volume"]["host_us"],
              "kernel_us": cc["volume"]["kernel_us"],
              "kernels_per_call": cc["volume"]["kernels_per_call"],
              "plain_sweeps_per_slice": cc["volume"]["plain_sweeps"],
              "served_shape": {k: cc["served"][k] for k in keys},
              "maze": {k: cc["maze"][k] for k in keys}}
    prop_row = {"name": "masked_max_prop", "route": "cuda", "source": source,
                "replaces": replaces, "launches": probe_launches,
                "launches_by_path": {"probe": probe_launches},
                "max_abs_err": 0.0, "ms": probe["ms"],
                "plain_ms": probe["plain_ms"], "bound_ms": probe["bound_ms"],
                "bound_by": probe["bound_by"], "library_ms": None,
                "shape": probe["shape"], "iters": probe["iters"],
                "warm_ms": probe["warm_ms"],
                "kernel_us": probe["kernel_us"],
                "kernels_per_call": probe["kernels_per_call"],
                "plan": probe["plan"],
                "serial_floor_cluster_ms": probe["serial_floor_cluster_ms"],
                "serial_floor_one_sm_ms": probe["serial_floor_one_sm_ms"]}
    return cc_row, prop_row, request["launches"]


# --------------------------------------------------------------------------
# Phase 9: the rest of the 2-D surface
# --------------------------------------------------------------------------

def _bf16_spacing(m: float) -> float:
    """The gap between bf16 numbers at magnitude ``m``."""
    return float(2.0 ** (np.floor(np.log2(m)) - 7))


def _quant_batch(tmp: str) -> torch.Tensor:
    """QUANT_BATCH slices of phase 6's training packs, on the CPU."""
    with open(os.path.join(tmp, "lists", "train.txt"),
              encoding="utf-8") as f:
        src = SliceStore.from_files(f.read().split())
    return torch.from_numpy(src.images[:QUANT_BATCH[0], None].copy())


def bf16_checkpoint(dev: torch.device, ckpt: str, x: torch.Tensor) -> dict:
    """The ``amp`` checkpoint's bf16 logits (``model_apply_fn``, as the CLI
    and the daemon run it) card vs CPU, and its f32 logits on the card
    (TF32 off) beside them."""
    model, margs = load_model_from_ckpt(ckpt, dev)
    cpu_model, _ = load_model_from_ckpt(ckpt, "cpu")
    if not margs.get("amp") or model.compute_dtype != torch.bfloat16:
        raise AssertionError(f"phase 6's checkpoint loads as "
                             f"{model.compute_dtype}, amp {margs.get('amp')}")
    with torch.inference_mode():
        card = model_apply_fn(model, lambda t: t)(x.to(dev)).cpu()
        t1 = time.perf_counter()
        cpu = model_apply_fn(cpu_model, lambda t: t)(x)
        cpu_s = time.perf_counter() - t1
        with f32_on_card(dev):
            f32 = model(x.to(dev)).cpu()
    scale = float(cpu.abs().max())
    bound = BF16_SPACINGS * _bf16_spacing(scale)
    d = (card - cpu).abs()
    far = cpu.abs() > bound
    out = {"batch": list(x.shape), "logits_max_abs": scale,
           "bound": bound, "bound_rule": f"{BF16_SPACINGS} bf16 spacings at "
                                         "max|logit|",
           "max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
           "bit_equal_share": float((d == 0).float().mean()),
           "masks_differ_beyond_bound": int(((card > 0) != (cpu > 0))[
               far].sum()),
           "cpu_s": cpu_s,
           "f32_vs_bf16_card_max_abs": float((f32 - card).abs().max()),
           "f32_vs_bf16_card_mean_abs": float((f32 - card).abs().mean()),
           "f32_vs_bf16_mask_pixels_differ": int(((f32 > 0) != (card > 0))
                                                 .sum())}
    if (not bool(torch.isfinite(card).all()) or out["max_abs_err"] > bound
            or out["masks_differ_beyond_bound"]):
        raise AssertionError(f"bf16 logits card vs CPU: {out}")
    return out


def _served_kspace(url: str, runner, seed: int) -> dict:
    """One SERVE_SLICES-slice /v1/segment_kspace request against the
    runner's in-process result, and the mask kernels' launches on it."""
    kpair = synthetic_kspace_pairs(seed=seed, s=SERVE_SLICES, h=VOLUME[1],
                                   w=VOLUME[2])
    expected = runner.segment_kspace(kpair, 0.5, False)
    reset_mask_launches()
    t1 = time.perf_counter()
    out = _post(url + "/v1/segment_kspace", _npz_bytes(kspace=kpair))
    latency = time.perf_counter() - t1
    launches = mask_launches()
    if set(launches.values()) != {1}:
        raise AssertionError(f"a {runner.source} request launched the mask "
                             f"kernels {launches} times, not once each")
    for key in ("mask", "body_mask"):
        if (out[key].shape != (SERVE_SLICES, 320, 320)
                or not np.array_equal(out[key], expected[key])):
            raise AssertionError(f"served {runner.source} {key} differs "
                                 "from in-process")
    return {"launches": launches, "latency_s": latency,
            "mask_pixels_on": int(out["mask"].sum())}


def bf16_served(dev: torch.device, ckpt: str) -> dict:
    server, thread, url = _start_server(ckpt, dev)
    try:
        runner = server.RequestHandlerClass.runner
        if runner.compute_dtype != torch.bfloat16:
            raise AssertionError(f"the daemon serves phase 6's checkpoint in "
                                 f"{runner.compute_dtype}")
        out = _served_kspace(url, runner, seed=400)
    finally:
        _stop_server(server, thread)
    return {"compute_dtype": "bfloat16", **out}


def int8_exact(dev: torch.device) -> dict:
    """ResNet34's first decoder conv, K = 3*3*768, sums past 2^24: the
    card's int32 sums against int64 numpy."""
    rng = np.random.default_rng(0)
    x = rng.integers(90, 128, (2, 10, 10, 768))
    x[0, :, :, ::7] = rng.integers(-127, 128, x[0, :, :, ::7].shape)
    x[1] = -x[1]
    w = rng.integers(90, 128, (3, 3, 768, 32))
    w[..., ::5] = rng.integers(-127, 128, w[..., ::5].shape)
    got = int8_conv(torch.from_numpy(x.astype(np.int8)).to(dev),
                    torch.from_numpy(w.astype(np.int8)).to(dev), 1, 1)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = np.zeros((2, 10, 10, 32), np.int64)
    for dy in range(3):
        for dx in range(3):
            want += np.einsum("nhwc,co->nhwo", xp[:, dy:dy + 10, dx:dx + 10],
                              w[dy, dx])
    got = got.cpu().numpy().astype(np.int64)
    out = {"k": 3 * 3 * 768, "shape": [2, 10, 10, 768], "cout": 32,
           "max_abs_sum": int(np.abs(want).max()),
           "max_abs_err": int(np.abs(got - want).max())}
    if out["max_abs_sum"] <= 2 ** 24 or out["max_abs_err"] != 0:
        raise AssertionError(f"int8 convolution on the card: {out}")
    return out


def int8_card_vs_cpu(dev: torch.device, q: str, x: torch.Tensor) -> dict:
    eng, tree, meta = quantize.load_engine(q, dev)
    _, cpu_tree, _ = quantize.load_engine(q, "cpu")
    card = eng.apply(tree, x.to(dev)).cpu()
    t1 = time.perf_counter()
    cpu = eng.apply(cpu_tree, x)
    cpu_s = time.perf_counter() - t1
    out = {"compute_dtype": meta["compute_dtype"], "mode": meta["mode"],
           "max_abs_err": float((card - cpu).abs().max()),
           "bit_equal": bool(torch.equal(card, cpu)),
           "logits_max_abs": float(cpu.abs().max()), "cpu_s": cpu_s}
    if not out["bit_equal"]:
        raise AssertionError(f"int8 logits card vs CPU: {out}")
    return out


def infer_quantized(dev: torch.device, tmp: str, ckpt: str, q: str) -> dict:
    """cli.infer --metrics on the val list: the checkpoint (bf16), the
    artifact (int8) and the checkpoint quantized to folded."""
    lst = os.path.join(tmp, "lists", "val.txt")
    out = {}
    for name, extra in (("bf16", ["--ckpt", ckpt]), ("int8_qtree",
                                                     ["--qtree", q]),
                        ("folded", ["--ckpt", ckpt, "--quant", "folded"])):
        out_dir = os.path.join(tmp, "preds_q_" + name)
        t1 = time.perf_counter()
        rc = infer.main(["--list", lst, "--out-dir", out_dir, "--metrics",
                         "--device", str(dev), *extra])
        secs = time.perf_counter() - t1
        with open(os.path.join(out_dir, "summary.json"),
                  encoding="utf-8") as f:
            summary = json.load(f)
        if rc != 0 or not summary or not all(
                np.isfinite(e[k]) for e in summary
                for k in ("dice", "iou", "hd95", "assd")):
            raise AssertionError(f"infer {name}: rc {rc}, {summary}")
        out[name] = {"s": secs, "dice": [e["dice"] for e in summary],
                     "hd95": [e["hd95"] for e in summary]}
    return out


def int8_served(dev: torch.device, q: str, x: torch.Tensor) -> dict:
    """A --qtree daemon: one /v1/segment_kspace and one /v1/segment
    request, each equal to in-process, and its /metricsz."""
    server, thread, url = _start_server(None, dev, qtree=q)
    try:
        runner = server.RequestHandlerClass.runner
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        if health["source"] != "qtree":
            raise AssertionError(f"/healthz: {health}")
        kspace = _served_kspace(url, runner, seed=401)
        vol = x[:SERVE_SLICES, 0].numpy()
        reply = _post(url + "/v1/segment?probs=1", _npz_bytes(img=vol))
        want = runner.segment(vol, 0.5, True)
        if not (np.array_equal(reply["probs"], want["probs"])
                and np.array_equal(reply["mask"], want["mask"])):
            raise AssertionError("served int8 /v1/segment differs from "
                                 "in-process")
        metrics = _metricsz(url)
        # the two requests over HTTP and their two in-process twins
        if (metrics["serve_requests_total"] != 4
                or metrics["serve_errors_total"] != 0):
            raise AssertionError(f"/metricsz: {metrics}")
    finally:
        _stop_server(server, thread)
    return {"compute_dtype": str(runner.compute_dtype), "kspace": kspace,
            "segment_slices": int(vol.shape[0]), "metricsz": metrics}


def time_batch(dev: torch.device, ckpt: str, q: str,
               x: torch.Tensor) -> dict:
    """Warm ms of one QUANT_BATCH batch (``cuda_ms``, host out of the
    window) at f32 with TF32 off, bf16, folded bf16 and int8, with the
    peak memory of each."""
    model, _ = load_model_from_ckpt(ckpt, dev)
    eng, tree, _ = quantize.load_engine(q, dev)
    folded = QuantizedUNet2D(eng.encoder, eng.classes, eng.decoder_channels,
                             QuantConfig("folded", eng.config.compute_dtype),
                             arch=eng.arch)
    xd = x.to(dev)
    bf16 = model_apply_fn(model, lambda t: t)
    runs = {"f32": lambda: model(xd), "bf16": lambda: bf16(xd),
            "folded": lambda: folded.apply(tree, xd),
            "int8": lambda: eng.apply(tree, xd)}
    out = {}
    with torch.inference_mode(), f32_on_card(dev):
        for name, fn in runs.items():
            fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out[name] = cuda_ms(fn, cold=False, iters=QUANT_TIMED_RUNS)
            out[name]["peak_gib"] = (torch.cuda.max_memory_allocated()
                                     / 2 ** 30)
    late = {k: v["late_runs"] for k, v in out.items() if v["late_runs"]}
    if late:
        raise AssertionError(f"host time inside the timed window: {late}")
    return {"batch": list(x.shape), "ms": {k: v["ms"] for k, v in
                                           out.items()}, "runs": out}


def _launch_flags(tmp: str, dev: torch.device, out_dir: str,
                  *extra) -> list:
    return ["--skip-preprocess", "--skip-split",
            "--train-list", os.path.join(tmp, "lists", "train.txt"),
            "--val-list", os.path.join(tmp, "lists", "val.txt"),
            "--out-dir", out_dir, "--epochs", "2", "--batch-size", "8",
            "--store-dtype", "bfloat16", "--logger", "noop",
            "--device", str(dev), *extra]


def _trainer(tmp: str, dev: torch.device, out_dir: str, *extra):
    """The launcher's trainer of these flags, not yet run."""
    flags = _launch_flags(tmp, dev, out_dir, *extra)
    ns = launcher.build_parser().parse_args(flags)
    return launcher.build_trainer(ns.train_list, ns.val_list, ns.out_dir, ns)


def resume_run(tmp: str, dev: torch.device) -> dict:
    """A launcher run preempted by ``request_preempt()`` during its first
    chunk, snapshotting at the chunk's end, then resumed with --resume:
    history.json and best.ckpt bit-equal to a straight run of the same
    flags without chunks. cuDNN deterministic, its autotuner off."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    straight, cut = os.path.join(tmp, "straight"), os.path.join(tmp, "cut")
    try:
        t1 = time.perf_counter()
        if launcher.main(_launch_flags(tmp, dev, straight)) != 0:
            raise AssertionError("the straight launcher run failed")
        straight_s = time.perf_counter() - t1
        t = _trainer(tmp, dev, cut, "--save-resume-steps",
                     str(RESUME_SAVE_STEPS))
        real = t.engine.train_steps

        def preempting(store, perm, gen):
            out = real(store, perm, gen)
            t.request_preempt()
            return out
        t.engine.train_steps = preempting
        first = t.run()
        if not first["summary"].get("preempted") or first["history"]:
            raise AssertionError(f"the run was not cut in its first epoch: "
                                 f"{first['summary']}")
        snaps = sorted(os.listdir(os.path.join(cut, "checkpoints")))
        if launcher.main(_launch_flags(
                tmp, dev, cut, "--save-resume-steps", str(RESUME_SAVE_STEPS),
                "--resume")) != 0:
            raise AssertionError("the resumed launcher run failed")
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    hist = [json.load(open(os.path.join(d, "history.json"),
                           encoding="utf-8")) for d in (straight, cut)]
    best = [load_best(os.path.join(d, "best.ckpt")) for d in (straight, cut)]
    differ = [k for k in best[0] if not torch.equal(best[0][k], best[1][k])]
    out = {"train_slices": t.train_store.num_slices,
           "steps_per_epoch": t.train_store.num_slices // 8,
           "snapshots_at_cut": snaps, "history": hist[1],
           "history_equal": hist[0] == hist[1],
           "best_ckpt_tensors": len(best[0]),
           "best_ckpt_tensors_differ": differ, "straight_s": straight_s}
    if not out["history_equal"] or differ or best[0].keys() != best[1].keys():
        raise AssertionError(f"resumed run differs from straight: {out}")
    return out


def encoder_weights_and_profile(tmp: str, dev: torch.device) -> dict:
    """--encoder-weights with a seeded torchvision ResNet34 file: the
    encoder before the first step holds the file's weights (the 1-channel
    stem as the file's three channels summed in order), the rest the
    seeded init; one epoch with --profile-epochs 1 leaves a trace naming
    CUDA kernels."""
    path = os.path.join(tmp, "resnet34_torchvision.pt")
    sd = torchvision_resnet_state_dict("resnet34", seed=7)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    out_dir = os.path.join(tmp, "pretrained")
    t = _trainer(tmp, dev, out_dir, "--encoder-weights", path, "--epochs",
                 "1", "--profile-epochs", "1")
    enc = {k: v.cpu() for k, v in t.model.encoder.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    want = convert_resnet_encoder(load_torch_checkpoint(path), "resnet34",
                                  stem_in_ch=1)
    stem = sd["conv1.weight"]
    stem = (stem[:, 0:1] + stem[:, 1:2]) + stem[:, 2:3]
    differ = [k for k in want if not torch.equal(enc[k], want[k])]
    if (differ or enc.keys() != want.keys() or not np.array_equal(
            enc["stem_conv.weight"].numpy(), stem)
            or not torch.equal(enc["blocks.15.conv1.weight"], torch.from_numpy(
                sd["layer4.2.conv2.weight"]))):
        raise AssertionError(f"imported encoder differs from the file: "
                             f"{differ[:5]}")
    t.run()
    traces = sorted(os.listdir(os.path.join(out_dir, "profile")))
    with open(os.path.join(out_dir, "profile", traces[0]),
              encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    if traces != ["epoch_001.pt.trace.json"] or not kernels:
        raise AssertionError(f"profile: {traces}, {len(kernels)} kernels")
    return {"encoder_tensors": len(want), "traces": traces,
            "cuda_kernel_events": len(kernels),
            "distinct_cuda_kernels": len(set(kernels)),
            "history": t.history}


def phase_rest_2d(dev: torch.device, defaults: dict, tmp: str) -> dict:
    """Phase 9: returns the mask kernels' launches on its two served
    /v1/segment_kspace requests, by route."""
    t0 = time.perf_counter()
    _set_precision_flags(defaults)
    ckpt = os.path.join(tmp, "run", "best.ckpt")
    x = _quant_batch(tmp)
    out = {"bf16_checkpoint": bf16_checkpoint(dev, ckpt, x),
           "bf16_served": bf16_served(dev, ckpt),
           "int8_exact": int8_exact(dev)}
    q = os.path.join(tmp, "quant_int8.npz")
    t1 = time.perf_counter()
    if quantize.main(["--ckpt", ckpt, "--list",
                      os.path.join(tmp, "lists", "val.txt"), "--out", q,
                      "--device", str(dev)]) != 0:
        raise AssertionError("cli.quantize failed")
    with open(q + ".meta.json", encoding="utf-8") as f:
        meta = json.load(f)
    if meta["compute_dtype"] != "bfloat16" or meta["mode"] != "int8":
        raise AssertionError(f"artifact meta: {meta}")
    out["quantize"] = {"s": time.perf_counter() - t1, "meta": meta,
                       "bytes": os.path.getsize(q)}
    out["int8_card_vs_cpu"] = int8_card_vs_cpu(dev, q, x)
    out["infer"] = infer_quantized(dev, tmp, ckpt, q)
    out["int8_served"] = int8_served(dev, q, x)
    out["timing"] = time_batch(dev, ckpt, q, x)
    out["resume"] = resume_run(tmp, dev)
    out["encoder_weights_profile"] = encoder_weights_and_profile(tmp, dev)
    if _precision_flags() != defaults:
        raise AssertionError(f"phase 9 left the precision flags changed: "
                             f"{_precision_flags()}, not {defaults}")
    emit({"phase": "rest_2d", "seconds": time.perf_counter() - t0, **out})
    return {"serve_bf16": out["bf16_served"]["launches"],
            "serve_qtree": out["int8_served"]["kspace"]["launches"]}


# --------------------------------------------------------------------------
# Phase 10: the corpus route, reduced
# --------------------------------------------------------------------------

def phase_corpus(dev: torch.device, defaults: dict, tmp: str) -> dict:
    """``tools/corpus_run.py`` at the b8 bar on CORPUS_VOLUMES volumes of
    the corpus at full size and width, CORPUS_EPOCHS epoch, without the
    quantized runs: the packs made in memory on the card, one launch of
    each mask kernel a pack, counted from 0 just before; the launcher's
    split and train; ``cli.infer --metrics`` on the val list. Returns the
    launches and the run's lists."""
    t0 = time.perf_counter()
    _set_precision_flags(defaults)
    reset_mask_launches()
    out = corpus_run.run("b8", os.path.join(tmp, "corpus"),
                         volumes=CORPUS_VOLUMES, device=str(dev),
                         epochs=CORPUS_EPOCHS, quantized=False)
    launches = mask_launches()
    if set(launches.values()) != {CORPUS_VOLUMES}:
        raise AssertionError(f"{CORPUS_VOLUMES} corpus packs launched the "
                             f"mask kernels {launches} times")
    missing = [f for f in RUN_FILES if not os.path.isfile(
        os.path.join(out["run_dir"], f))]
    numbers = (out["val_dice_by_epoch"] + out["val_loss_by_epoch"]
               + out["epoch_s"] + out["train_slices_per_sec"]
               + [out["infer_metrics"][k] for k in ("dice", "iou")])
    if (missing or len(out["val_dice_by_epoch"]) != CORPUS_EPOCHS
            or not all(np.isfinite(numbers))):
        raise AssertionError(f"the corpus run: missing {missing}, {out}")
    emit({"phase": "corpus", "seconds": time.perf_counter() - t0,
          "launches": launches, **{k: v for k, v in out.items()
                                   if k not in ("flags", "card")}})
    return {"launches": launches, "lists": out["lists"]}


# --------------------------------------------------------------------------
# Phase 11: the 3-D patch path at full width
# --------------------------------------------------------------------------

def _flags_3d(lists: str, out_dir: str, dev: torch.device, *extra) -> list:
    return ["--train-list", os.path.join(lists, "train.txt"),
            "--val-list", os.path.join(lists, "val.txt"),
            "--out-dir", out_dir, "--epochs", "1",
            "--batch-size", str(BATCH_3D), "--samples-per-vol-train", "1",
            "--samples-per-vol-val", "1", "--device", str(dev), *extra]


def train_3d_cli(lists: str, tmp: str, dev: torch.device,
                 sampling: str) -> dict:
    """``train/trainer3d.py``'s CLI at the reference width, ROI and batch
    with ``--amp``: one patch a train volume, one epoch."""
    out_dir = os.path.join(tmp, f"run3d_{sampling}")
    extra = ["--roi", *map(str, ROI_3D), "--channels",
             *map(str, CHANNELS_3D), "--amp"]
    if sampling == "device":
        extra.append("--device-sampling")
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    if trainer3d.main(_flags_3d(lists, out_dir, dev, *extra)) != 0:
        raise AssertionError(f"trainer3d ({sampling} sampling) failed")
    secs = time.perf_counter() - t1
    with open(os.path.join(out_dir, "train_log.csv"), encoding="utf-8") as f:
        rows = f.read().split()
    vals = [float(v) for v in rows[1].split(",")[1:]]
    if (rows[0] != "epoch,train_loss,val_loss,lr" or len(rows) != 2
            or not all(np.isfinite(vals))
            or not os.path.isfile(os.path.join(out_dir, "best3d.ckpt"))):
        raise AssertionError(f"trainer3d ({sampling}): {rows}")
    return {"seconds": secs, "train_log": rows[1],
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "ckpt": os.path.join(out_dir, "best3d.ckpt")}


def time_3d_step(dev: torch.device, remat: bool) -> dict:
    """ms a train step (bf16 forward + DiceCE + backward + AdamW) at the
    reference width, ROI and batch, and the peak memory, by CUDA events
    over TIMED_STEPS_3D steps after two warm-up steps."""
    model = build_unet3d(1, 1, CHANNELS_3D, dtype=torch.bfloat16,
                         remat=remat)
    init_weights3d(model, torch.Generator().manual_seed(0))
    model.to(dev).train()
    params = list(model.parameters())
    opt = make_optimizer(params, 1e-3, 1e-4, 0.0)
    yy, xx, dd = ROI_3D
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((BATCH_3D, 1, dd, yy, xx), generator=gen, device=dev)
    y = (torch.rand((BATCH_3D, 1, dd, yy, xx), generator=gen, device=dev)
         > 0.7).float()

    def step():
        loss = dice_ce_loss_3d_binary(model(x), y)
        opt.step(list(torch.autograd.grad(loss, params)))
        return loss
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, loss = back_to_back_ms(step, TIMED_STEPS_3D)
    out = {"remat": remat, "ms_per_step": ms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "loss": float(loss.detach())}
    del model, opt, x, y
    torch.cuda.empty_cache()
    if not np.isfinite(out["loss"]):
        raise AssertionError(f"3-D step: {out}")
    return out


def step_3d_card_vs_cpu(dev: torch.device) -> dict:
    """One f32 DiceCE step of a narrow 3-D U-Net on the card (TF32 off) and
    on the CPU from the same weights and batch: the loss and every
    gradient."""
    model = init_weights3d(build_unet3d(1, 1, NARROW_3D),
                           torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    yy, xx, dd = NARROW_ROI_3D
    x = torch.from_numpy(rng.standard_normal(
        (BATCH_3D, 1, dd, yy, xx)).astype(np.float32))
    y = torch.from_numpy((rng.random((BATCH_3D, 1, dd, yy, xx)) > 0.6
                          ).astype(np.float32))
    out = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        m = copy.deepcopy(model).to(d)
        with f32_on_card(d):
            loss = dice_ce_loss_3d_binary(m(x.to(d)), y.to(d))
            grads = torch.autograd.grad(loss, list(m.parameters()))
        out[name] = (float(loss.detach()), [g.cpu() for g in grads])
    (lc, gc), (lg, gg) = out["cpu"], out["card"]
    big = max(float(g.abs().max()) for g in gc)
    worst = max(float((a - b).abs().max()) / (
        STEP3D_GRAD_RTOL * float(b.abs().max()) + STEP3D_GRAD_FLOOR * big)
                for a, b in zip(gg, gc))
    res = {"channels": list(NARROW_3D), "roi": list(NARROW_ROI_3D),
           "loss_rel_err": abs(lg - lc) / abs(lc),
           "grad_err_over_bound_max": worst,
           "grad_rule": f"{STEP3D_GRAD_RTOL} x max|g| + "
                        f"{STEP3D_GRAD_FLOOR} x the net's max|g|"}
    if res["loss_rel_err"] > STEP3D_LOSS_RTOL or worst > 1.0:
        raise AssertionError(f"3-D step card vs CPU: {res}")
    return res


def infer_3d_whole_volume(lists: str, tmp: str, dev: torch.device,
                          ckpt: str) -> dict:
    """``cli.infer --ckpt3d --metrics`` on the first val volume, whole."""
    with open(os.path.join(lists, "val.txt"), encoding="utf-8") as f:
        first = f.read().split()[0]
    one = os.path.join(tmp, "val3d_one.txt")
    with open(one, "w", encoding="utf-8") as f:
        f.write(first)
    out_dir = os.path.join(tmp, "preds3d")
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    if infer.main(["--ckpt3d", ckpt, "--list", one, "--out-dir", out_dir,
                   "--metrics", "--device", str(dev)]) != 0:
        raise AssertionError("cli.infer --ckpt3d failed")
    secs = time.perf_counter() - t1
    with np.load(first) as z:
        shape = z["msk"].shape
    pred = np.load(os.path.join(out_dir, os.path.basename(
        os.path.dirname(first)), "pred_mask.npy"))
    with open(os.path.join(out_dir, "summary.json"), encoding="utf-8") as f:
        summary = json.load(f)[0]
    if pred.shape != shape or not np.isfinite(summary["dice"]):
        raise AssertionError(f"--ckpt3d: {pred.shape} vs {shape}, {summary}")
    padded = [-(-n // 16) * 16 for n in shape]
    return {"seconds": secs, "volume": list(shape), "padded_to": padded,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "summary": {k: summary[k] for k in ("dice", "iou", "hd95",
                                                "assd")}}


def resume_3d(lists: str, tmp: str, dev: torch.device) -> dict:
    """A narrow 3-D run preempted after epoch 1 of 2 and resumed, against
    a straight run: train_log.csv and every weight bit-equal, cuDNN
    deterministic, its autotuner off."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    extra = ["--roi", *map(str, NARROW_ROI_3D), "--channels",
             *map(str, NARROW_3D), "--epochs", "2", "--amp"]
    straight, cut = (os.path.join(tmp, n) for n in ("r3d_ref", "r3d_cut"))
    try:
        if trainer3d.main(_flags_3d(lists, straight, dev, *extra)) != 0:
            raise AssertionError("the straight 3-D run failed")
        t = trainer3d.UNet3DTrainer(trainer3d.parse_args(
            _flags_3d(lists, cut, dev, *extra)), dev)
        real = t.train_one_epoch

        def preempting():
            out = real()
            t.request_preempt()
            return out
        t.train_one_epoch = preempting
        t.fit()
        snaps = sorted(os.listdir(os.path.join(cut, "checkpoints")))
        if trainer3d.main(_flags_3d(lists, cut, dev, *extra,
                                    "--resume")) != 0:
            raise AssertionError("the resumed 3-D run failed")
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    logs = [open(os.path.join(d, "train_log.csv"), encoding="utf-8").read()
            for d in (straight, cut)]
    best = [load_best(os.path.join(d, "best3d.ckpt")) for d in (straight,
                                                                 cut)]
    differ = [k for k in best[0] if not torch.equal(best[0][k], best[1][k])]
    out = {"snapshots_at_cut": snaps, "train_log": logs[1].split(),
           "log_equal": logs[0] == logs[1], "tensors": len(best[0]),
           "tensors_differ": differ}
    if snaps != ["resume_000001"] or not out["log_equal"] or differ:
        raise AssertionError(f"resumed 3-D run differs: {out}")
    return out


def phase_3d(dev: torch.device, defaults: dict, tmp: str,
             lists: str) -> dict:
    """Phase 11 on phase 10's packs and lists. Returns the mask kernels'
    launches on the 3-D path (none)."""
    t0 = time.perf_counter()
    _set_precision_flags(defaults)
    reset_mask_launches()
    out = {"train_host": train_3d_cli(lists, tmp, dev, "host"),
           "train_device": train_3d_cli(lists, tmp, dev, "device")}
    out["infer_ckpt3d"] = infer_3d_whole_volume(
        lists, tmp, dev, out["train_host"]["ckpt"])
    launches = mask_launches()
    out["step"] = [time_3d_step(dev, remat) for remat in (True, False)]
    out["f32_step_card_vs_cpu"] = step_3d_card_vs_cpu(dev)
    out["resume"] = resume_3d(lists, tmp, dev)
    if _precision_flags() != defaults:
        raise AssertionError(f"phase 11 left the precision flags changed: "
                             f"{_precision_flags()}, not {defaults}")
    emit({"phase": "patch3d", "seconds": time.perf_counter() - t0,
          "launches": launches, "channels": list(CHANNELS_3D),
          "roi": list(ROI_3D), "batch": BATCH_3D, **out})
    return launches


# --------------------------------------------------------------------------
# Phase 12: classical recon and the ingest route
# --------------------------------------------------------------------------

def _timed_recon(run, slices: int) -> dict:
    """One warm-up run, then RECON_TIMED_RUNS by the host clock with the
    card synchronized; the last run's output and the peak memory."""
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(RECON_TIMED_RUNS):
        t1 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
    return out, {"case_s": secs, "slice_s": [t / slices for t in secs],
                 "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _maps_vs_cpu(got: dict, want: dict) -> dict:
    """Per output key: max |card - CPU| / max |CPU| and the pixels past
    RECON_REL of the CPU map's maximum."""
    if set(got) != set(want):
        raise AssertionError(f"keys {sorted(got)} vs {sorted(want)}")
    out = {}
    for key in sorted(want):
        a, b = np.asarray(got[key]), np.asarray(want[key])
        if a.shape != b.shape or not np.isfinite(a).all():
            raise AssertionError(f"{key}: {a.shape} vs {b.shape}, finite "
                                 f"{np.isfinite(a).all()}")
        scale = float(np.abs(b).max())
        diff = np.abs(a - b)
        out[key] = {"rel_err": float(diff.max()) / scale,
                    "pixels_past": int((diff > RECON_REL * scale).sum()),
                    "pixels": int(b.size)}
    return out


def _mesh_vs_one(run_mesh, got: dict, thresholded=()) -> dict:
    """One timed run of a recon with its slices spread over ``[cuda:0,
    cuda:0]`` against the one-device output ``got``: each key within
    RECON_MESH_TOL (rtol and atol), a thresholded key at most
    RECON_PIXELS_PAST of its pixels past; the largest difference."""
    t1 = time.perf_counter()
    out = run_mesh()
    torch.cuda.synchronize()
    res = {"case_s": time.perf_counter() - t1, "devices": 2, "keys": {}}
    for key, want in got.items():
        a, b = np.asarray(out[key]), np.asarray(want)
        past = np.abs(a - b) > RECON_MESH_TOL * (1 + np.abs(b))
        res["keys"][key] = {"max_abs_diff": float(np.abs(a - b).max()),
                            "pixels_past": int(past.sum())}
        allowed = (RECON_PIXELS_PAST * b.size if key in thresholded else 0)
        if a.shape != b.shape or past.sum() > allowed:
            raise AssertionError(f"recon on [cuda:0, cuda:0] vs one device, "
                                 f"{key}: {res['keys'][key]}")
    res["max_abs_diff"] = max(v["max_abs_diff"] for v in res["keys"].values())
    return res


def recon_cli_refusal(tmp: str) -> dict:
    """``cli.recon --data-parallel`` asking one card more than there are
    raises as JAX's ``make_mesh`` does."""
    n, have = torch.cuda.device_count() + 1, torch.cuda.device_count()
    want = f"requested {n} devices, have {have}"
    try:
        recon_cli.main(["--data-path", tmp, "--output-path",
                        os.path.join(tmp, "recon_refused"), "--sequence",
                        "t2", "--data-parallel", str(n)])
    except ValueError as exc:
        if str(exc) != want:
            raise AssertionError(f"cli.recon said {exc!r}, not {want!r}"
                                 ) from exc
        return {"data_parallel": n, "said": str(exc)}
    raise AssertionError(f"cli.recon --data-parallel {n} on {have} card(s) "
                         "ran")


def t2_protocol(dev: torch.device) -> dict:
    """The T2 protocol case on the card, timed, against the port on the CPU
    on slice 0 (slices are independent), and once with its slices spread
    over ``[cuda:0, cuda:0]`` against the one-device output."""
    k, calib = probe_recon.t2_protocol_case(0, T2_CASE)
    run = lambda: t2_reconstruction(k, calib, device=dev)  # noqa: E731
    got, timing = _timed_recon(run, T2_CASE[1])
    on_mesh = _mesh_vs_one(lambda: t2_reconstruction(
        k, calib, mesh=[dev, dev], device=dev), got)
    t1 = time.perf_counter()
    want = t2_reconstruction(k[:, :1], calib[:1], device="cpu")
    cpu_s = time.perf_counter() - t1
    vs = _maps_vs_cpu({"reconstruction_rss": got["reconstruction_rss"][:1]},
                      want)
    shape = got["reconstruction_rss"].shape
    if shape != (T2_CASE[1], min(320, T2_CASE[3]), min(320, T2_CASE[4])) or (
            vs["reconstruction_rss"]["rel_err"] > RECON_CARD_REL):
        raise AssertionError(f"T2 protocol case: {shape}, {vs}")
    return {"case": list(T2_CASE), "r": probe_recon.T2_R,
            "acs": probe_recon.T2_ACS, "output": list(shape), **timing,
            "mesh": on_mesh, "cpu_one_slice_s": cpu_s,
            "card_vs_cpu_slice0": vs["reconstruction_rss"],
            "stages_s": probe_recon.t2_stages(dev, k, calib),
            "traced": probe_recon.card_busy(run)}


def dwi_protocol(dev: torch.device) -> dict:
    """The DWI protocol case on the card, timed, and one slice on the card
    against the port on the CPU for every output key (the b1500 noise floor
    is a median over the whole volume, so both sides run the same slice);
    once with its slices spread over ``[cuda:0, cuda:0]`` against the
    one-device output."""
    k, calib, sens, hdr = probe_recon.dwi_protocol_case(1, DWI_CASE)
    run = lambda: dwi_reconstruction(  # noqa: E731
        k, calib, sens, hdr, device=dev)
    got, timing = _timed_recon(run, DWI_CASE[1])
    on_mesh = _mesh_vs_one(lambda: dwi_reconstruction(
        k, calib, sens, hdr, mesh=[dev, dev], device=dev), got,
        DWI_THRESHOLDED)
    one = (k[:, :1], calib[:1], sens[:1], hdr)
    t1 = time.perf_counter()
    want = dwi_reconstruction(*one, device="cpu")
    cpu_s = time.perf_counter() - t1
    vs = _maps_vs_cpu(dwi_reconstruction(*one, device=dev), want)
    shapes = {key: list(v.shape) for key, v in got.items()}
    bad = [key for key, v in vs.items()
           if v["rel_err"] > RECON_CARD_REL and (
               key not in DWI_THRESHOLDED
               or v["pixels_past"] > RECON_PIXELS_PAST * v["pixels"])]
    crop = (DWI_CASE[1], min(100, DWI_CASE[3]), min(100, DWI_CASE[4]))
    if bad or set(map(tuple, shapes.values())) != {crop}:
        raise AssertionError(f"DWI protocol case: {shapes}, {vs}")
    return {"case": list(DWI_CASE), "r": probe_recon.DWI_R, "epi": hdr,
            **timing, "mesh": on_mesh, "cpu_one_slice_s": cpu_s,
            "keys": sorted(got),
            "card_vs_cpu_one_slice": vs,
            "stages_s": probe_recon.dwi_stages(dev, k, calib, sens, hdr),
            "traced": probe_recon.card_busy(run)}


def _write_pickled_volumes(root: str) -> list:
    """PCK_VOLUMES seeded magnitude volumes, one ``{"data": (S, H, W)
    float32}`` pickle each."""
    paths = []
    for i in range(PCK_VOLUMES):
        imgs = synthetic_knee_volume(100 + i, *PCK_VOLUME)
        path = os.path.join(root, f"vol{i}.pck")
        with open(path, "wb") as f:
            pickle.dump({"data": imgs}, f)
        paths.append(path)
    return paths


def pickle_ingest(dev: torch.device, tmp: str) -> dict:
    """``build_preprocess`` with ``KneePckAdapter`` on the card: each mask
    kernel launched once a volume (counted from 0 just before), nothing
    redone with ``skip_existing``; then the packs through the slice store's
    native npz loader, bit-equal to ``np.load``."""
    root, art = os.path.join(tmp, "pck"), os.path.join(tmp, "pck_art")
    os.makedirs(root)
    _write_pickled_volumes(root)
    spec = dict(root_dir=root, out_dir=art, height=320, width=320,
                slice_keep="0.3,0.7", clip="1.0,99.5", use_n4=False,
                use_denoise=False, preview_max=6, device=str(dev))
    reset_mask_launches()
    t1 = time.perf_counter()
    first = build_preprocess(SimpleNamespace(**spec), KneePckAdapter())
    build_s = time.perf_counter() - t1
    launches = mask_launches()
    t1 = time.perf_counter()
    again = build_preprocess(SimpleNamespace(**spec, skip_existing=True),
                             KneePckAdapter())
    skip_s = time.perf_counter() - t1
    redo = mask_launches()
    files = [e["npz_path"] for e in first]
    t1 = time.perf_counter()
    store = SliceStore.from_files(files, workers=PCK_VOLUMES)
    load_s = time.perf_counter() - t1
    ref = []
    for f in files:
        with np.load(f) as z:
            ref.append((z["img"], z["msk"]))
    equal = (np.array_equal(store.images, np.concatenate(
        [img[:, 0] for img, _ in ref])) and np.array_equal(
        store.masks, np.concatenate([msk for _, msk in ref]).astype(
            np.int32)))
    single = [native.load_volume_npz(f) for f in files]
    equal = equal and all(
        x is not None and np.array_equal(x[0], img)
        and np.array_equal(x[1], msk) for x, (img, msk) in zip(single, ref))
    out = {"volumes": PCK_VOLUMES, "volume": list(PCK_VOLUME),
           "launches": launches, "build_s": build_s,
           "slices": [e["num_slices"] for e in first],
           "skip_existing": {"s": skip_s, "launches": redo,
                             "skipped": sum(bool(e.get("skipped_existing"))
                                            for e in again)},
           "native_npz_built": native.native_available(),
           "native_npz_error": native_build.ERRORS.get("npz_loader"),
           "store_load_s": load_s, "store_equals_np_load": equal}
    if (set(launches.values()) != {PCK_VOLUMES} or redo != launches
            or out["skip_existing"]["skipped"] != PCK_VOLUMES
            or not out["native_npz_built"] or not equal
            or out["slices"] != [14] * PCK_VOLUMES):
        raise AssertionError(f"the pickle ingest route: {out}")
    return out


def h5_route(tmp: str) -> dict:
    """Without h5py, every ``.h5`` entry point raises an ImportError naming
    it; where h5py is installed, a written fixture is read instead."""
    root = os.path.join(tmp, "h5")
    os.makedirs(root)
    try:
        import h5py
    except ImportError:
        messages = {}
        for name, call in (
                ("discover_records", lambda: FastMRISinglecoilAdapter(
                    root_dir=root).discover_records()),
                ("load_file_T2", lambda: recon_data.load_file_T2(
                    os.path.join(root, "case.h5")))):
            try:
                call()
            except ImportError as exc:
                messages[name] = str(exc)
            else:
                raise AssertionError(f"{name} served without h5py")
        if not all("h5py" in m for m in messages.values()):
            raise AssertionError(f"refusals that do not name h5py: "
                                 f"{messages}")
        return {"h5py": False, "native_h5": native.native_h5_available(),
                "refusals": messages}
    path = os.path.join(root, "vol.h5")
    ksp = probe_recon.complex_normal(np.random.default_rng(7), (4, 64, 48))
    with h5py.File(path, "w") as hf:
        hf.create_dataset("kspace", data=ksp, chunks=(1, 64, 48),
                          compression="gzip")
    vol = FastMRISinglecoilAdapter(root_dir=root).load_volume(path)
    if not np.array_equal(vol["kspace_pair"],
                          np.stack([ksp.real, ksp.imag], -1)):
        raise AssertionError("the .h5 fixture read back differs")
    return {"h5py": True, "native_h5": native.native_h5_available(),
            "read_fixture": list(ksp.shape)}


def phase_recon_ingest(dev: torch.device, defaults: dict, tmp: str,
                       smi: str) -> dict:
    """Phase 12 from torch's own precision flags (the recon sets TF32 off
    itself). Returns the mask kernels' launches on the recon path (none)
    and on the pickle ingest path (one each a volume)."""
    t0 = time.perf_counter()
    _set_precision_flags(defaults)
    reset_mask_launches()
    out = {"card": smi, "t2": t2_protocol(dev)}
    out["dwi"] = dwi_protocol(dev)
    out["recon_cli_refusal"] = recon_cli_refusal(tmp)
    recon_launches = mask_launches()
    for seq in ("t2", "dwi"):
        print(f"{seq} on [cuda:0, cuda:0]: largest difference from one "
              f"device {out[seq]['mesh']['max_abs_diff']:.3g} (rtol / atol "
              f"{RECON_MESH_TOL}), {out[seq]['mesh']['case_s']:.3f} s a case "
              f"(one device {min(out[seq]['case_s']):.3f} s)", flush=True)
    if any(recon_launches.values()):
        raise AssertionError(f"the recon launched mask kernels: "
                             f"{recon_launches}")
    out["ingest_pck"] = pickle_ingest(dev, tmp)
    out["h5"] = h5_route(tmp)
    if _precision_flags() != defaults:
        raise AssertionError(f"phase 12 left the precision flags changed: "
                             f"{_precision_flags()}, not {defaults}")
    emit({"phase": "recon_ingest", "seconds": time.perf_counter() - t0,
          "launches_recon": recon_launches, **out})
    return {"recon": recon_launches,
            "ingest_pck": out["ingest_pck"]["launches"]}


def _b50_samples(samples: list) -> list:
    """b50-shaped samples (three averages, maps with one) made of three
    protocol slices each: k-space ``(12, 3, 320, 320, 2)``."""
    return [samples[i]._replace(kspace=np.concatenate(
        [t.kspace for t in samples[i:i + VARNET_AVES]], axis=1))
        for i in range(0, len(samples) - VARNET_AVES + 1, VARNET_AVES)]


def _as_tensors(sample, dev: torch.device) -> tuple:
    """A sample's k-space, maps, target and max value, batched, on
    ``dev``."""
    return (torch.from_numpy(sample.kspace[None]).to(dev),
            torch.from_numpy(sample.espirit[None]).to(dev),
            torch.from_numpy(sample.target[None]).to(dev),
            torch.tensor([sample.max_value], dtype=torch.float32).to(dev))


def _varnet_in(args: VarNetArgs, aves: int, state: dict,
               dtype: torch.dtype) -> torch.nn.Module:
    """The VarNet of ``args`` with the weights ``state``, computing in
    ``dtype`` (float64 for a reference run)."""
    ref = VarNet(aves, 1, args.num_cascades, args.sens_chans,
                 args.sens_pools, args.chans, args.pools, dtype=dtype)
    ref.load_state_dict(state)
    return ref.to(dtype)


def _varnet(args: VarNetArgs, aves: int,
            dtype: torch.dtype | None = None) -> torch.nn.Module:
    """The VarNet of ``args`` with VARNET_SEED's weights, in ``dtype``
    (default the args' own; float64 for a reference run)."""
    model = init_fastmri_weights(
        build_varnet_from_args(args, aves=aves, sens_aves=1),
        torch.Generator().manual_seed(VARNET_SEED))
    if dtype is None:
        return model
    return _varnet_in(args, aves, model.state_dict(), dtype)


def _ulp_moved(x: torch.Tensor) -> torch.Tensor:
    """Every non-zero element of ``x`` moved by one f32 ulp, up or down at
    random (seeded); zeros stay: they are the sampling mask."""
    up = torch.rand(x.shape, generator=torch.Generator().manual_seed(0)) < 0.5
    moved = torch.nextafter(x, torch.where(up, torch.inf, -torch.inf))
    return torch.where(x != 0, moved, x)


def varnet_forward_card_vs_cpu(dev: torch.device, sample) -> tuple:
    """The VarNetArgs defaults (12 cascades, chans 18, b50) on one 12-coil
    320x320 slice in f32, card (TF32 off) vs CPU, and in float64 both
    sides. From a random init the network amplifies rounding: its f32
    output lies some 1e-3 of its maximum from float64, on the CPU too. So
    f32 card vs CPU is held to VARNET_FWD_FLOOR_X times the CPU's own f32
    distance from float64 on this input (or VARNET_FWD_RTOL, when larger),
    and float64 card vs CPU to VARNET_F64_RTOL. Returns the result and the
    f32 model."""
    args = VarNetArgs(amp=False)
    model = _varnet(args, VARNET_AVES).eval()
    k, e, _, _ = _as_tensors(sample, torch.device("cpu"))
    out = {}
    for name, m, d, dt in (
            ("cpu", model, torch.device("cpu"), torch.float32),
            ("cpu64", _varnet(args, VARNET_AVES, torch.float64),
             torch.device("cpu"), torch.float64),
            ("card", model, dev, torch.float32),
            ("card64", _varnet(args, VARNET_AVES, torch.float64), dev,
             torch.float64)):
        m = copy.deepcopy(m).to(d).eval()
        t0 = time.perf_counter()
        with torch.no_grad(), f32_on_card(d):
            out[name] = m(k.to(d, dt), e.to(d, dt)).cpu().double()
        out[name + "_s"] = time.perf_counter() - t0
        del m
    torch.cuda.empty_cache()
    mx = float(out["cpu64"].abs().max())

    def rel(a, b):
        return float((out[a] - out[b]).abs().max()) / mx
    floor = rel("cpu", "cpu64")
    res = {"shape": list(k.shape), "out": list(out["cpu"].shape),
           "rel_err_to_max": rel("card", "cpu"),
           "cpu_f32_vs_f64": floor, "card_f32_vs_f64": rel("card", "cpu64"),
           "tolerance": max(VARNET_FWD_RTOL, VARNET_FWD_FLOOR_X * floor),
           "f64_rel_err_to_max": rel("card64", "cpu64"),
           "f64_tolerance": VARNET_F64_RTOL,
           "cpu_forward_s": out["cpu_s"], "cpu64_forward_s": out["cpu64_s"],
           "finite": bool(torch.isfinite(out["card"]).all())}
    if (res["rel_err_to_max"] > res["tolerance"] or not res["finite"]
            or res["f64_rel_err_to_max"] > VARNET_F64_RTOL):
        raise AssertionError(f"VarNet forward card vs CPU: {res}")
    return res, model


def _varnet_grads(model: torch.nn.Module, sample, d: torch.device,
                  kspace: torch.Tensor | None = None,
                  dtype: torch.dtype = torch.float32) -> dict:
    """One SSIM-loss step's loss and gradients (by parameter name) from
    ``model``'s weights on ``d`` (TF32 off), the inputs in ``dtype`` (the
    model's own: f32, or float64 for a reference run)."""
    m = copy.deepcopy(model).to(d).train()
    k, e, t, mv = (x.to(dtype) for x in _as_tensors(sample, d))
    if kspace is not None:
        k = kspace.to(d, dtype)
    t0 = time.perf_counter()
    with f32_on_card(d):
        loss = varnet_loss(m, k, e, t, mv, crop=100)
        grads = torch.autograd.grad(loss, list(m.parameters()))
    names = [n for n, _ in m.named_parameters()]
    return {"loss": float(loss.detach()), "s": time.perf_counter() - t0,
            "grads": {n: g.cpu() for n, g in zip(names, grads)}}


def _step_rule(card: dict, cpu: dict, moved: dict) -> dict:
    """Card vs CPU of one step: the loss relative, and each gradient
    tensor's max difference relative to its max |g|, against the same of
    the CPU step from a one-ulp-moved input (the floor), phase 6's rule."""
    grad_rel = _rel_to_max(card["grads"], cpu["grads"])
    floor_rel = _rel_to_max(moved["grads"], cpu["grads"])
    floor = max(floor_rel.values())
    loss_floor = abs(moved["loss"] - cpu["loss"]) / abs(cpu["loss"])
    worst = max(grad_rel, key=grad_rel.get)
    out = {"loss": cpu["loss"],
           "loss_rel_err": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
           "loss_rel_one_ulp": loss_floor,
           "loss_tol": max(STEP_LOSS_RTOL, STEP_GRAD_FLOOR_X * loss_floor),
           "grad_worst_rel_to_max": grad_rel[worst],
           "grad_worst_tensor": worst,
           "grad_median_rel_to_max": float(np.median(list(
               grad_rel.values()))),
           "grad_tensors": len(grad_rel),
           "grad_floor_one_ulp": floor,
           "grad_tol": max(STEP_GRAD_RTOL, STEP_GRAD_FLOOR_X * floor),
           "cpu_step_s": cpu["s"]}
    if (out["loss_rel_err"] > out["loss_tol"]
            or out["grad_worst_rel_to_max"] > out["grad_tol"]):
        raise AssertionError(f"step card vs CPU: {out}")
    return out


def _f64_rule(card: dict, cpu: dict) -> dict:
    """Card vs CPU of one float64 step, where rounding cannot show: the
    loss relative and each gradient tensor's max difference relative to
    its max |g|, both held to STEP_GRAD_F64_RTOL (phase 6's rule)."""
    grad_rel = _rel_to_max(card["grads"], cpu["grads"])
    worst = max(grad_rel, key=grad_rel.get)
    out = {"f64_loss_rel_err": abs(card["loss"] - cpu["loss"])
           / abs(cpu["loss"]),
           "f64_grad_worst_rel_to_max": grad_rel[worst],
           "f64_grad_worst_tensor": worst,
           "f64_grad_median_rel_to_max": float(np.median(list(
               grad_rel.values()))),
           "f64_grad_tensors": len(grad_rel),
           "f64_tol": STEP_GRAD_F64_RTOL, "f64_cpu_step_s": cpu["s"]}
    if (out["f64_loss_rel_err"] > STEP_GRAD_F64_RTOL
            or out["f64_grad_worst_rel_to_max"] > STEP_GRAD_F64_RTOL):
        raise AssertionError(f"float64 step card vs CPU: {out}")
    return out


def varnet_step_card_vs_cpu(dev: torch.device, ckpt: str, sample) -> dict:
    """One f32 SSIM-loss step, card (TF32 off) vs CPU, from the weights of
    the protocol recipe's short run (``ckpt``, loaded into the f32 protocol
    configuration) on a validation slice: the loss and every gradient under
    :func:`_step_rule`. Trained weights, because from a random init the
    full-width gradients are rounding noise: a one-ulp move of the input
    moves some tensor's gradient by its whole size, on the CPU alone. At
    full width when the CPU's two steps (the plain and the one-ulp one) stay
    under VARNET_STEP_CPU_S, else at VARNET_NARROW_CASCADES cascades. The
    same step in float64 on both sides, at VARNET_F64_CASCADES cascades (the
    second one's ``dc_weight`` has a gradient; the first's soft-DC term is
    zero), under :func:`_f64_rule`."""
    with open(ckpt + ".args.json", encoding="utf-8") as f:
        args = VarNetArgs(**{**json.load(f), "amp": False})
    state = load_best(ckpt)
    model = build_varnet_from_args(args, aves=1)
    model.load_state_dict(state)
    cpu_dev = torch.device("cpu")
    k = torch.from_numpy(sample.kspace[None])
    cpu = _varnet_grads(model, sample, cpu_dev)
    full = 2 * cpu["s"] < VARNET_STEP_CPU_S
    if not full:
        model.cascades = model.cascades[:VARNET_NARROW_CASCADES]
        cpu = _varnet_grads(model, sample, cpu_dev)
    moved = _varnet_grads(model, sample, cpu_dev, _ulp_moved(k))
    card = _varnet_grads(model, sample, dev)
    ref = _varnet_in(args, 1, state, torch.float64)
    ref.cascades = ref.cascades[:VARNET_F64_CASCADES]
    f64 = _f64_rule(*(_varnet_grads(ref, sample, d, dtype=torch.float64)
                      for d in (dev, cpu_dev)))
    return {"weights": f"protocol run, {VARNET_SMOKE_EPOCHS} epoch(s)",
            "cascades": len(model.cascades), "full_width": full,
            **_step_rule(card, cpu, moved),
            "f64_cascades": len(ref.cascades), **f64}


def varnet_step_time(dev: torch.device, trainer: VarNetTrainer,
                     samples: list, batch: int, trace: bool = False) -> dict:
    """ms a bf16 training step (upload, forward, SSIM loss, backward,
    AdamW) through ``VarNetTrainer._step_batch`` and the peak memory, by
    CUDA events over VARNET_TIMED steps after VARNET_WARMUP; with
    ``trace`` one more step under ``torch.profiler``: the card's busy
    share and its costliest kernels."""
    chunk = samples[:batch]
    for _ in range(VARNET_WARMUP):
        trainer._step_batch(chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, loss = back_to_back_ms(lambda: trainer._step_batch(chunk),
                               VARNET_TIMED)
    out = {"batch": batch, "ms_per_step": ms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "loss": float(loss)}
    if trace:
        out["trace"] = probe_recon.card_busy(
            lambda: trainer._step_batch(chunk))
    if not np.isfinite(out["loss"]):
        raise AssertionError(f"VarNet step: {out}")
    return out


def varnet_serving(dev: torch.device, ckpt: str, proto: list,
                   b50_model: torch.nn.Module, b50: list, tmp: str) -> dict:
    """``--task recon`` daemons: the protocol run's checkpoint answers a
    5-D and a batched 6-D request, a b50 checkpoint (random f32 weights,
    three averages) one whose maps have one average; each reply equal to
    the in-process runner's result, and no mask kernel launched."""
    reset_mask_launches()
    out = {}
    server, thread, url = _start_server(ckpt, dev, task="recon")
    runner = server.RequestHandlerClass.runner
    reqs = {"5d": (proto[0].kspace, proto[0].espirit),
            "6d_batch2": (np.stack([s.kspace for s in proto[1:3]]),
                          np.stack([s.espirit for s in proto[1:3]]))}
    got = {n: _post(url + "/v1/reconstruct", _npz_bytes(
        kspace=k, espirit=e))["recon"] for n, (k, e) in reqs.items()}
    out["metricsz"] = {k: v for k, v in _metricsz(url).items()
                       if k in ("serve_requests_total", "serve_slices_total")}
    for n, (k, e) in reqs.items():
        want = runner.reconstruct(k, e)["recon"]
        if got[n].shape != want.shape or not np.array_equal(got[n], want):
            raise AssertionError(f"/v1/reconstruct {n} differs from "
                                 "in-process: max "
                                 f"{np.abs(got[n] - want).max()}")
        out[n] = {"shape": list(got[n].shape),
                  "finite": bool(np.isfinite(got[n]).all())}
    _stop_server(server, thread)
    if out["metricsz"] != {"serve_requests_total": 2.0,
                           "serve_slices_total": 3.0}:
        raise AssertionError(f"/metricsz after 3 slices in 2 requests: "
                             f"{out['metricsz']}")
    b50_ckpt = os.path.join(tmp, "varnet_b50", "varnet_best.ckpt")
    os.makedirs(os.path.dirname(b50_ckpt))
    save_best(b50_ckpt, b50_model.state_dict(),
              dataclasses.asdict(VarNetArgs(amp=False)))
    server, thread, url = _start_server(b50_ckpt, dev, task="recon")
    k, e = b50[0].kspace, b50[0].espirit
    got = _post(url + "/v1/reconstruct", _npz_bytes(kspace=k,
                                                    espirit=e))["recon"]
    want = server.RequestHandlerClass.runner.reconstruct(k, e)["recon"]
    _stop_server(server, thread)
    if not np.array_equal(got, want):
        raise AssertionError("/v1/reconstruct b50 with one-average maps "
                             "differs from in-process")
    out["b50_singleton_maps"] = {"kspace": list(k.shape),
                                 "espirit": list(e.shape),
                                 "recon": list(got.shape)}
    out["launches"] = mask_launches()
    if any(out["launches"].values()):
        raise AssertionError(f"the recon daemon launched mask kernels: "
                             f"{out['launches']}")
    return out


def _unet_grads(model: torch.nn.Module, x: torch.Tensor, y: torch.Tensor,
                d: torch.device) -> dict:
    """One f32 L1 step's loss and gradients from ``model``'s weights on
    ``d`` (TF32 off)."""
    m = copy.deepcopy(model).to(d).train()
    t0 = time.perf_counter()
    with f32_on_card(d):
        loss = torch.mean(torch.abs(m(x.to(d)) - y.to(d)))
        grads = torch.autograd.grad(loss, list(m.parameters()))
    names = [n for n, _ in m.named_parameters()]
    return {"loss": float(loss.detach()), "s": time.perf_counter() - t0,
            "grads": {n: g.cpu() for n, g in zip(names, grads)}}


def unet_recon_full_width(dev: torch.device, proto: list, zero_filled: list,
                          tmp: str) -> dict:
    """``UnetReconTrainer`` at full width (chans 32, 4 pools) on 320x320
    zero-filled / target pairs: one f32 step card vs CPU (TF32 off; the
    loss and every gradient under :func:`_step_rule`; in float64 under
    :func:`_f64_rule`), and ms a bf16 step."""
    samples = [unet_transform(zf, s.target, s.fname, 0, s.max_value)
               for s, zf in zip(proto, zero_filled)]
    out = {}
    tr = UnetReconTrainer(UnetReconArgs(out_dir=os.path.join(
        tmp, "unet_recon"), amp=False), samples, samples,
        device=torch.device("cpu"))
    x, y = next(tr._batches(samples[:UNET_RECON_BATCH], False))
    cpu = _unet_grads(tr.model, x, y, torch.device("cpu"))
    moved = _unet_grads(tr.model, _ulp_moved(x), y, torch.device("cpu"))
    card = _unet_grads(tr.model, x, y, dev)
    a = tr.args
    ref = FastMRIUnet(a.in_chans, a.out_chans, a.chans, a.num_pool_layers,
                      a.drop_prob, torch.float64)
    ref.load_state_dict(tr.model.state_dict())
    ref = ref.to(torch.float64)
    f64 = _f64_rule(*(_unet_grads(ref, x.double(), y.double(), d)
                      for d in (dev, torch.device("cpu"))))
    out["step_f32"] = {"batch": UNET_RECON_BATCH,
                       **_step_rule(card, cpu, moved), **f64}
    tr = UnetReconTrainer(UnetReconArgs(out_dir=os.path.join(
        tmp, "unet_recon"), amp=True), samples, samples, device=dev)
    x, y = next(tr._batches(samples[:UNET_RECON_BATCH], False))
    for _ in range(VARNET_WARMUP):
        tr.step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, loss = back_to_back_ms(lambda: tr.step(x, y), VARNET_TIMED)
    out["step_bf16"] = {"batch": UNET_RECON_BATCH, "ms_per_step": ms,
                        "peak_gib": torch.cuda.max_memory_allocated()
                        / 2 ** 30, "loss": float(loss)}
    return out


def recon_h5_clis(tmp: str) -> dict:
    """Without h5py, ``cli.train_varnet`` and ``cli.evaluate`` raise an
    ImportError naming it; where h5py is installed they run on a written
    DWI fixture instead."""
    root = os.path.join(tmp, "dwi")
    for split in ("train", "val"):
        os.makedirs(os.path.join(root, split))
    calls = {
        "train_varnet": lambda: train_varnet.main([
            "--data-path", root, "--out-dir", os.path.join(tmp, "vn_h5"),
            "--epochs", "1", "--num-cascades", "1", "--chans", "4",
            "--pools", "2", "--sens-chans", "4", "--sens-pools", "2"]),
        "evaluate": lambda: evaluate_cli.main([
            "--target-path", os.path.join(root, "train"),
            "--predictions-path", os.path.join(tmp, "vn_h5")])}
    try:
        import h5py  # noqa: F401
    except ImportError:
        messages = {}
        for name, call in calls.items():
            try:
                call()
            except ImportError as exc:
                messages[name] = str(exc)
            else:
                raise AssertionError(f"{name} served without h5py")
        if not all("h5py" in m for m in messages.values()):
            raise AssertionError(f"refusals that do not name h5py: "
                                 f"{messages}")
        return {"h5py": False, "refusals": messages}
    for split, seed in (("train", 0), ("val", 1)):
        varnet_synthetic.write_dwi_h5(
            os.path.join(root, split, "case.h5"), seed)
    rc = calls["train_varnet"]()
    return {"h5py": True, "train_varnet_rc": rc}


def phase_varnet(dev: torch.device, defaults: dict, tmp: str) -> dict:
    """Phase 13 from torch's own precision flags: VarNet and the recon
    U-Net. Returns the mask kernels' launches on these paths (none)."""
    t0 = time.perf_counter()
    _set_precision_flags(defaults)
    reset_mask_launches()
    proto, proto_zf = varnet_synthetic.make_samples("protocol", "train")
    b50 = _b50_samples(proto)
    out = {}
    out["forward"], b50_model = varnet_forward_card_vs_cpu(dev, b50[0])
    configs = {"protocol": (VarNetArgs(
        out_dir=os.path.join(tmp, "vn_time"),
        **varnet_synthetic.RECIPES["protocol"]["args"]), proto),
        "defaults": (VarNetArgs(out_dir=os.path.join(tmp, "vn_time")), b50)}
    out["step_time"] = {}
    for name in VARNET_TIMING:
        args, samples = configs[name]
        trainer = VarNetTrainer(args, device=dev)
        out["step_time"][name] = [
            varnet_step_time(dev, trainer, samples, b,
                             trace=(name == "protocol" and b == 1))
            for b in VARNET_BATCHES]
        del trainer
        torch.cuda.empty_cache()
    run = varnet_synthetic.run("protocol", str(dev), os.path.join(
        tmp, "varnet_protocol"), epochs=VARNET_SMOKE_EPOCHS)
    with open(os.path.join(tmp, "varnet_protocol", "history.json"),
              encoding="utf-8") as f:
        history = json.load(f)
    out["train_protocol"] = {
        "by_epoch": [{k: h[k] for k in ("epoch", "train_loss", "nmse",
                                        "ssim", "psnr", "seconds")}
                     for h in history],
        "baseline_zero_filled": run["baseline_zero_filled"]}
    ckpt = os.path.join(tmp, "varnet_protocol", "varnet_best.ckpt")
    proto_val = varnet_synthetic.make_samples("protocol", "val")[0]
    out["step_f32"] = varnet_step_card_vs_cpu(dev, ckpt, proto_val[0])
    out["serve"] = varnet_serving(dev, ckpt, proto_val, b50_model, b50, tmp)
    out["unet_recon"] = unet_recon_full_width(dev, proto[:4], proto_zf[:4],
                                              tmp)
    out["h5_clis"] = recon_h5_clis(tmp)
    launches = mask_launches()
    if any(launches.values()):
        raise AssertionError(f"phase 13 launched mask kernels: {launches}")
    if _precision_flags() != defaults:
        raise AssertionError(f"phase 13 left the precision flags changed: "
                             f"{_precision_flags()}, not {defaults}")
    emit({"phase": "varnet", "seconds": time.perf_counter() - t0,
          "launches": launches, **out})
    return {"varnet": launches}


def _cls_model(variant: str, in_chans: int, seed: int) -> ConvNeXt:
    """A seeded f32 ConvNeXt (Flax's init) with its layer scales at 1:
    at Flax's 1e-6 the blocks would hardly move the logits, and a check of
    the forward would hold little more than the stem and the head."""
    model = init_convnext_weights(ConvNeXt(variant, in_chans),
                                  torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for blocks in model.stages:
            for block in blocks:
                block.gamma.fill_(1.0)
    return model.eval()


def _cls_as(model: ConvNeXt, dtype: torch.dtype) -> ConvNeXt:
    """``model``'s weights in a model computing in ``dtype`` (float64: the
    parameters too)."""
    m = ConvNeXt(model.variant, model.in_chans, dtype=dtype)
    m.load_state_dict(model.state_dict())
    return (m.double() if dtype == torch.float64 else m).eval()


def _cls_logits(model: ConvNeXt, x: torch.Tensor, d: torch.device,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    m = copy.deepcopy(model).to(d)
    with torch.no_grad(), f32_on_card(d):
        out = m(x.to(d, dtype)).cpu().double()
    del m
    return out


def cls_forward_card_vs_cpu(dev: torch.device) -> dict:
    """f32 forward card (TF32 off) vs CPU of base at full width and of tiny
    at the odd size, each gated by CLS_FWD_FLOOR_X times the CPU's own f32
    distance from a float64 run (or CLS_FWD_RTOL); base in bf16 card vs
    CPU within CLS_BF16_SPACINGS bf16 spacings at the largest |logit|."""
    cpu = torch.device("cpu")
    out = {}
    cases = {"convnext_224": ("convnext", 1, (CLS_SIZE, CLS_SIZE)),
             "tiny_2ch_50x70": ("tiny", 2, CLS_ODD)}
    for name, (variant, chans, hw) in cases.items():
        model = _cls_model(variant, chans, seed=14)
        x = torch.from_numpy(np.random.default_rng(14).standard_normal(
            (CLS_FWD_BATCH, chans, *hw)).astype(np.float32))
        t0 = time.perf_counter()
        want = _cls_logits(model, x, cpu)
        cpu_s = time.perf_counter() - t0
        ref = _cls_logits(_cls_as(model, torch.float64), x, cpu,
                          torch.float64)
        got = _cls_logits(model, x, dev)
        mx = float(ref.abs().max())
        floor = float((want - ref).abs().max()) / mx
        res = {"input": list(x.shape),
               "rel_err_to_max": float((got - want).abs().max()) / mx,
               "cpu_f32_vs_f64": floor,
               "card_f32_vs_f64": float((got - ref).abs().max()) / mx,
               "tolerance": max(CLS_FWD_RTOL, CLS_FWD_FLOOR_X * floor),
               "max_abs_logit": mx, "cpu_forward_s": cpu_s,
               "finite": bool(torch.isfinite(got).all())}
        if res["rel_err_to_max"] > res["tolerance"] or not res["finite"]:
            raise AssertionError(f"ConvNeXt {name} forward card vs CPU: "
                                 f"{res}")
        out[name] = res
        if variant == "convnext":
            bf = _cls_as(model, torch.bfloat16)
            got16, want16 = _cls_logits(bf, x, dev), _cls_logits(bf, x, cpu)
            spacing = _bf16_spacing(float(want16.abs().max()))
            res16 = {"spacings_at_max": float((got16 - want16).abs().max())
                     / spacing, "tolerance": CLS_BF16_SPACINGS,
                     "bf16_vs_f64_spacings": float((got16 - ref).abs().max())
                     / spacing}
            if res16["spacings_at_max"] > CLS_BF16_SPACINGS:
                raise AssertionError(f"ConvNeXt bf16 card vs CPU: {res16}")
            out[name + "_bf16"] = res16
    return out


class _Weights:
    """A dataset stand-in for the trainer: the class weights only."""
    weights = [0.35, 0.65]


def cls_time_ckpt(tmp: str, variant: str) -> str:
    """The best checkpoint :func:`cls_step_time` saves for ``variant``."""
    return os.path.join(tmp, f"clf_time_{variant}", "classifier_best.ckpt")


def cls_step_time(dev: torch.device, tmp: str, variant: str, diff: bool,
                  trace: bool) -> dict:
    """ms a bf16 training step (forward, weighted BCE, backward, the
    AMSGrad chain) through ``ClassifierTrainer.train_step`` at batch
    CLS_BATCH, 224x224, and the peak memory, by CUDA events over
    CLS_TIMED steps after CLS_WARMUP; with ``trace`` one more step under
    ``torch.profiler``: the card's busy share and its costliest kernels,
    and the kernels a step launches. The bound is the step's convolution
    and matmul FLOP (3x the forward's, ``torch.utils.flop_counter``) at
    the card's bf16 peak. The trained weights are saved as the trainer's
    best checkpoint (:func:`cls_time_ckpt`)."""
    tr = ClassifierTrainer(ClassifierArgs(
        out_dir=os.path.dirname(cls_time_ckpt(tmp, variant)),
        model=variant, diff=diff, amp=True, amsgrad=True), _Weights(),
        _Weights(), device=dev)
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.standard_normal(
        (CLS_BATCH, 2 if diff else 1, CLS_SIZE, CLS_SIZE)).astype(
            np.float32)).to(dev)
    y = torch.from_numpy((rng.random(CLS_BATCH) < 0.35).astype(
        np.float32)).to(dev)
    for _ in range(CLS_WARMUP):
        tr.train_step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, (loss, _) = back_to_back_ms(lambda: tr.train_step(x, y), CLS_TIMED)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with FlopCounterMode(display=False) as flops, torch.no_grad():
        tr.model(x)
    # a step: the forward's FLOP and twice them backward (the counter's
    # backward formula takes a depthwise convolution for a dense one)
    step_flop = 3 * flops.get_total_flops()
    bound_ms = step_flop / BF16_FLOP_PER_S * 1e3
    out = {"variant": variant, "in_chans": 2 if diff else 1,
           "batch": CLS_BATCH, "ms_per_step": ms,
           "slices_per_s": CLS_BATCH / ms * 1e3, "peak_gib": peak,
           "gflop_per_step": step_flop / 1e9,
           "bound_ms": bound_ms, "bound_share": bound_ms / ms,
           "loss": float(loss)}
    if trace:
        out["trace"] = probe_recon.card_busy(lambda: tr.train_step(x, y))
        out["trace"]["launches"] = kernel_trace(
            lambda: tr.train_step(x, y), runs=2)["kernels_per_call"]
    if not np.isfinite(out["loss"]):
        raise AssertionError(f"ConvNeXt step: {out}")
    tr._save_best()
    del tr
    torch.cuda.empty_cache()
    return out


def _cls_grads(model: ConvNeXt, x: torch.Tensor, y: torch.Tensor,
               d: torch.device, dtype: torch.dtype = torch.float32) -> dict:
    """One weighted-BCE step's loss and gradients (by parameter name) from
    ``model``'s weights on ``d`` (TF32 off), the inputs in ``dtype`` (the
    model's own: f32, or float64 for a reference run)."""
    m = copy.deepcopy(model).to(d).train()
    t0 = time.perf_counter()
    with f32_on_card(d):
        loss = weighted_bce_loss(m(x.to(d, dtype)), y.to(d, dtype), tuple(
            _Weights.weights))
        grads = torch.autograd.grad(loss, list(m.parameters()))
    names = [n for n, _ in m.named_parameters()]
    return {"loss": float(loss.detach()), "s": time.perf_counter() - t0,
            "grads": {n: g.cpu() for n, g in zip(names, grads)}}


def cls_step_card_vs_cpu(dev: torch.device) -> dict:
    """One f32 step of base at full width (batch CLS_STEP_BATCH, 224x224)
    card (TF32 off) vs CPU, the loss and every gradient under phase 6's
    rule (:func:`_step_rule`); the same step in float64 on both sides
    under :func:`_f64_rule`."""
    model = _cls_model("convnext", 1, seed=15)
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal(
        (CLS_STEP_BATCH, 1, CLS_SIZE, CLS_SIZE)).astype(np.float32))
    y = torch.tensor([0.0, 1.0])
    cpu = torch.device("cpu")
    res = _step_rule(_cls_grads(model, x, y, dev),
                     _cls_grads(model, x, y, cpu),
                     _cls_grads(model, _ulp_moved(x), y, cpu))
    ref = _cls_as(model, torch.float64)
    f64 = _f64_rule(*(_cls_grads(ref, x, y, d, torch.float64)
                      for d in (dev, cpu)))
    return {"input": list(x.shape), **res, **f64}


def cls_recipe(dev: torch.device, tmp: str) -> tuple:
    """``tools/classify_synthetic.py`` whole, with its gate; returns the
    summary and the best checkpoint."""
    out_dir = os.path.join(tmp, "classify_synthetic")
    summary = classify_synthetic.run(out_dir, str(dev))
    if not summary["ok"]:
        raise AssertionError(f"classify_synthetic missed its gate (best "
                             f"val AUC > 0.9 and early stopping): {summary}")
    res = {k: summary[k] for k in ("epochs_ran", "early_stopping_fired",
                                   "best_val_auc", "final_val_auc",
                                   "final_val_loss", "wall_s",
                                   "seconds_per_epoch")}
    res["jax_record"] = {**JAX_CLASSIFY_RECORD, "seconds_per_epoch":
                         JAX_CLASSIFY_RECORD["wall_s"]
                         / JAX_CLASSIFY_RECORD["epochs_ran"]}
    return res, os.path.join(out_dir, "classifier_best.ckpt")


def cls_resume(dev: torch.device, tmp: str) -> dict:
    """The recipe for CLS_RESUME_EPOCHS epochs straight, and preempted by
    ``request_preempt()`` after epoch CLS_PREEMPT_AT and resumed in a new
    trainer: history and best checkpoint bit-equal (cuDNN deterministic)."""
    flags = _precision_flags()
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for name in ("straight", "resumed"):
            out_dir = os.path.join(tmp, f"classify_{name}")
            train_ds, val_ds = classify_synthetic.make_datasets()
            args = classify_synthetic.recipe_args(out_dir,
                                                  CLS_RESUME_EPOCHS)
            tr = ClassifierTrainer(args, train_ds, val_ds, device=dev)
            if name == "resumed":
                one_pass = tr._epoch_pass

                def preempting(train, ds=None, tr=tr, one_pass=one_pass):
                    res = one_pass(train, ds)
                    if not train and tr.epoch == CLS_PREEMPT_AT:
                        tr.request_preempt()
                    return res
                tr._epoch_pass = preempting
                first = len(tr.fit()["history"])
                tr = ClassifierTrainer(args, train_ds, val_ds, device=dev)
                tr.fit(resume=True)
            else:
                tr.fit()
            with open(os.path.join(out_dir, "history.json"),
                      encoding="utf-8") as f:
                runs[name] = (json.load(f), load_best(tr.best_path))
    finally:
        _set_precision_flags(flags)
    (h_a, sd_a), (h_b, sd_b) = runs["straight"], runs["resumed"]
    same = h_a == h_b and sd_a.keys() == sd_b.keys() and all(
        torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    out = {"epochs": len(h_a), "preempted_after": first,
           "history_equal": h_a == h_b, "best_ckpt_equal": same}
    if not same or first != CLS_PREEMPT_AT:
        raise AssertionError(f"classifier resume: {out}")
    return out


def _http_code(url: str, body: bytes) -> int:
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body),
                                    timeout=60) as r:
            return r.status
    except urllib.error.HTTPError as exc:
        return exc.code


def cls_serving_amp(dev: torch.device, ckpt: str) -> dict:
    """A ``--task classify`` daemon on an ``amp`` base checkpoint: bf16
    compute, and its reply to (N, H, W) slices at 224x224 equal to the
    in-process runner's."""
    server, thread, url = _start_server(ckpt, dev, task="classify")
    runner = server.RequestHandlerClass.runner
    try:
        x = np.random.default_rng(16).standard_normal(
            (CLS_SERVE_SLICES, CLS_SIZE, CLS_SIZE)).astype(np.float32)
        got = _post(url + "/v1/classify", _npz_bytes(x=x))["probs"]
        want = runner.classify(x)["probs"]
    finally:
        _stop_server(server, thread)
    out = {"input": list(x.shape), "probs": got.tolist(),
           "compute_dtype": str(runner.compute_dtype)}
    if (runner.compute_dtype != torch.bfloat16
            or got.shape != (CLS_SERVE_SLICES,)
            or not np.isfinite(got).all() or not np.array_equal(got, want)):
        raise AssertionError(f"/v1/classify amp: {out}, in-process "
                             f"{want.tolist()}")
    return out


def cls_serving(dev: torch.device, ckpt: str) -> dict:
    """A ``--task classify`` daemon on the recipe's best checkpoint: a
    ``/v1/classify`` reply equal to the in-process runner's, the 400 and
    404 answers, and ``/metricsz``."""
    server, thread, url = _start_server(ckpt, dev, task="classify")
    runner = server.RequestHandlerClass.runner
    try:
        _, val_ds = classify_synthetic.make_datasets()
        x = np.stack(val_ds.xs[:CLS_SERVE_SLICES]).transpose(0, 2, 3, 1)
        got = _post(url + "/v1/classify", _npz_bytes(x=x))["probs"]
        want = runner.classify(x)["probs"]
        codes = {
            "one_channel": _http_code(url + "/v1/classify",
                                      _npz_bytes(x=x[..., :1])),
            "no_x": _http_code(url + "/v1/classify", _npz_bytes(img=x)),
            "segment": _http_code(url + "/v1/segment",
                                  _npz_bytes(img=x[..., 0])),
            "segment_kspace": _http_code(url + "/v1/segment_kspace",
                                         _npz_bytes(kspace=x))}
        metrics = {k: v for k, v in _metricsz(url).items()
                   if k in ("serve_requests_total", "serve_slices_total",
                            "serve_errors_total")}
    finally:
        _stop_server(server, thread)
    labels = val_ds.labels[:CLS_SERVE_SLICES]
    out = {"probs": got.tolist(), "labels": labels.tolist(),
           "codes": codes, "metricsz": metrics,
           "compute_dtype": str(runner.compute_dtype)}
    # the in-process call counts as a request too
    want_metrics = {"serve_requests_total": 2.0,
                    "serve_slices_total": 2.0 * CLS_SERVE_SLICES,
                    "serve_errors_total": 2.0}
    if (got.shape != (CLS_SERVE_SLICES,) or not np.array_equal(got, want)
            or codes != {"one_channel": 400, "no_x": 400, "segment": 404,
                         "segment_kspace": 404}
            or metrics != want_metrics):
        raise AssertionError(f"/v1/classify: {out}, in-process "
                             f"{want.tolist()}")
    return out


def classify_h5_entry_points(tmp: str) -> dict:
    """Without h5py, the datasheet datasets and ``cli.train_classify``
    raise an ImportError naming it; where h5py is installed they are the
    CPU tests' (``tests/test_torch_classify.py``)."""
    sheet = os.path.join(tmp, "sheet.csv")
    with open(sheet, "w", encoding="utf-8") as f:
        f.write("fastmri_pt_id,fastmri_rawfile,folder,PIRADS,slice,"
                "data_split\n0,case0.h5,.,4,1,training\n")
    calls = {
        "T2SliceDataset": lambda: T2SliceDataset(sheet, tmp),
        "DWISliceDataset": lambda: DWISliceDataset(sheet, tmp),
        "train_classify": lambda: train_classify.main([
            "--mode", "dwi", "--datasheet", sheet, "--data-path", tmp,
            "--out-dir", os.path.join(tmp, "clf_h5"), "--epochs", "1"])}
    try:
        import h5py  # noqa: F401
    except ImportError:
        messages = {}
        for name, call in calls.items():
            try:
                call()
            except ImportError as exc:
                messages[name] = str(exc)
            else:
                raise AssertionError(f"{name} ran without h5py")
        if not all("h5py" in m for m in messages.values()):
            raise AssertionError(f"refusals that do not name h5py: "
                                 f"{messages}")
        return {"h5py": False, "refusals": messages}
    return {"h5py": True}


def phase_classify(dev: torch.device, defaults: dict, tmp: str) -> dict:
    """Phase 14 from torch's own precision flags: the ConvNeXt classifier.
    Returns the mask kernels' launches on this path (none)."""
    t0 = time.perf_counter()
    _set_precision_flags(defaults)
    reset_mask_launches()
    out = {"forward": cls_forward_card_vs_cpu(dev)}
    out["step_time"] = [
        cls_step_time(dev, tmp, "convnext", False, trace=True),
        cls_step_time(dev, tmp, "tiny", True, trace=False)]
    out["step_f32"] = cls_step_card_vs_cpu(dev)
    out["recipe"], ckpt = cls_recipe(dev, tmp)
    out["resume"] = cls_resume(dev, tmp)
    out["serve"] = cls_serving(dev, ckpt)
    out["serve_amp"] = cls_serving_amp(dev, cls_time_ckpt(tmp, "convnext"))
    out["h5_entry_points"] = classify_h5_entry_points(tmp)
    launches = mask_launches()
    if any(launches.values()):
        raise AssertionError(f"phase 14 launched mask kernels: {launches}")
    if _precision_flags() != defaults:
        raise AssertionError(f"phase 14 left the precision flags changed: "
                             f"{_precision_flags()}, not {defaults}")
    emit({"phase": "classify", "seconds": time.perf_counter() - t0,
          "launches": launches, **out})
    return {"classify": launches}


DP_VOLUMES = 2              # packed for phase 15: one to train, one to val
DP_SEGMENT_BATCH = 7        # a replica's chunk, and one device's batch
DP_SPIN_CYCLES = 200_000_000   # some 0.1 s of the card's clock


def dp_pack(dev: torch.device, tmp: str) -> tuple:
    """Phase 15's packs (the body mask's kernels once a volume) and their
    train and val lists."""
    pre = MRIKneePreprocessor(out_size=(320, 320), slice_keep=(0.3, 0.7),
                              device=dev)
    lists = []
    for i in range(DP_VOLUMES):
        d = os.path.join(tmp, "dp_art", f"vol{i}")
        pack_kspace_volume(pre, synthetic_kspace_pairs(
            seed=40 + i, s=VOLUME[0], h=VOLUME[1], w=VOLUME[2]), d)
        lists.append(os.path.join(tmp, f"dp_{i}.txt"))
        with open(lists[-1], "w", encoding="utf-8") as f:
            f.write(os.path.join(d, "volume.npz"))
    return lists[0], lists[1]


def dp_launcher_refusal(tmp: str) -> dict:
    """``cli.launcher --data-parallel`` asking one card more than there are
    raises as JAX's ``make_mesh`` does, before any rank starts."""
    n, have = torch.cuda.device_count() + 1, torch.cuda.device_count()
    want = f"requested {n} devices, have {have}"
    try:
        launcher.run_training(
            os.path.join(tmp, "dp_0.txt"), os.path.join(tmp, "dp_1.txt"),
            os.path.join(tmp, "dp_refused"), launcher.build_parser(
            ).parse_args(["--data-parallel", str(n)]))
    except ValueError as exc:
        if str(exc) != want:
            raise AssertionError(f"launcher refusal said {exc!r}, not "
                                 f"{want!r}") from exc
        return {"data_parallel": n, "said": str(exc)}
    raise AssertionError(f"--data-parallel {n} on {have} card(s) ran")


def dp_segment(dev: torch.device, val_list: str) -> dict:
    """``segment_volume_2d`` through a replica on each of ``[cuda:0,
    cuda:0]`` (a batch of 2 x DP_SEGMENT_BATCH split in two) against one
    device at a batch of DP_SEGMENT_BATCH: the same call shapes, so the
    probabilities and masks are bit-equal."""
    with np.load(read_list(val_list)[0]) as z:
        vol = torch.from_numpy(z["img"]).to(dev)
    model = _train_model(9).to(dev).eval()
    one = model_apply_fn(model, lambda x: x)
    dp = ReplicatedApply([one, model_apply_fn(copy.deepcopy(model),
                                              lambda x: x)], [dev, dev])
    want = segment_volume_2d(one, vol, batch_size=DP_SEGMENT_BATCH)
    got = segment_volume_2d(dp, vol, batch_size=2 * DP_SEGMENT_BATCH)
    masks_equal = torch.equal(threshold_probs(got, 1, 0.5),
                              threshold_probs(want, 1, 0.5))
    out = {"slices": int(vol.shape[0]), "devices": 2,
           "probs_bit_equal": torch.equal(got, want),
           "masks_bit_equal": masks_equal,
           "probs_max_abs_diff": float((got - want).abs().max())}
    if not (masks_equal and out["probs_bit_equal"]):
        raise AssertionError(f"data-parallel segment_volume_2d: {out}")
    return out


def dp_nccl_world1(dev: torch.device, train_list: str, tmp: str) -> dict:
    """A world-1 NCCL group (the NCCL path initializes and its collectives
    run) taking one U-Net step, held to the one-rank step by the ulp
    rule."""
    src = SliceStore.from_list(train_list)
    x = torch.from_numpy(src.images[:probe_data_parallel.GLOBAL_BATCH,
                                    None].copy())
    y = torch.from_numpy(src.masks[:probe_data_parallel.GLOBAL_BATCH]
                         .astype(np.uint8))
    group = mesh.make_mesh(1, 0, torch.device("cuda", dev.index or 0),
                           "file://" + os.path.join(tmp, "nccl_init"),
                           backend="nccl")
    try:
        got = probe_data_parallel.unet_step(group.device, x, y, group)
        waits = dp_barrier_waits(group)
    finally:
        torch.distributed.destroy_process_group()
    rule = probe_data_parallel.ulp_rule(
        got, probe_data_parallel.unet_step(dev, x, y),
        probe_data_parallel.unet_step(dev, probe_data_parallel.ulp_moved(x),
                                      y), "world-1 NCCL step")
    return {"backend": group.backend, "barrier": waits, **rule}


def dp_barrier_waits(group: mesh.DataGroup) -> dict:
    """``mesh.barrier`` under NCCL holds the host until the work queued on
    the card before it has run (NCCL only queues a collective): a spin of
    DP_SPIN_CYCLES clocks, still running when the barrier is called, has
    ended when it returns."""
    stream = torch.cuda.current_stream(group.device)
    torch.cuda.synchronize(group.device)
    torch.cuda._sleep(DP_SPIN_CYCLES)
    pending = not stream.query()
    t0 = time.perf_counter()
    mesh.barrier(group)
    out = {"spin_pending_before": pending, "spin_done_after": stream.query(),
           "barrier_ms": (time.perf_counter() - t0) * 1e3,
           "spin_cycles": DP_SPIN_CYCLES}
    if not (out["spin_pending_before"] and out["spin_done_after"]):
        raise AssertionError(f"barrier under NCCL did not wait for the "
                             f"card: {out}")
    return out


def dp_spread_preprocess(dev: torch.device) -> dict:
    """Phase 15's two volumes through ``preprocess_volumes_pairs(devices=
    [cuda:0, cuda:0])``, bit-equal to per-volume calls, each mask kernel
    launched once a volume in the spread call and in each per-volume
    call."""
    pre = MRIKneePreprocessor(out_size=(320, 320), slice_keep=(0.3, 0.7),
                              device=dev)
    pairs = [synthetic_kspace_pairs(seed=40 + i, s=VOLUME[0], h=VOLUME[1],
                                    w=VOLUME[2]) for i in range(DP_VOLUMES)]
    reset_mask_launches()
    got = pre.preprocess_volumes_pairs(pairs, devices=[dev, dev])
    spread = mask_launches()
    per_volume, equal = [], []
    for pair, g in zip(pairs, got):
        reset_mask_launches()
        want = pre.preprocess_volume_pairs(pair)
        per_volume.append(mask_launches())
        equal.append(all(torch.equal(g[key], want[key])
                         for key in ("tensor", "preview", "mask")))
    out = {"volumes": len(pairs), "devices": 2, "bit_equal": equal,
           "launches_spread": spread,
           "launches_per_volume": {k: v / len(pairs)
                                   for k, v in spread.items()},
           "launches_per_volume_call": per_volume}
    if not all(equal) or set(spread.values()) != {len(pairs)} or any(
            set(n.values()) != {1} for n in per_volume):
        raise AssertionError(f"preprocess_volumes_pairs over [cuda:0, "
                             f"cuda:0]: {out}")
    print(f"preprocess_volumes_pairs over [cuda:0, cuda:0]: {len(pairs)} "
          f"volumes bit-equal to per-volume calls, mask kernel launches "
          f"a volume {out['launches_per_volume']}", flush=True)
    return out


def dp_rank(group: mesh.DataGroup, probe_args: tuple, coil_args: tuple,
            mp_args: tuple) -> dict:
    """Phase 15's work on each of its ranks: the dry run's, the data-
    parallel probe's, the coil-parallel probe's and the point-to-point
    probe's (one spawn for all: a rank's start on the card costs some 20 s
    of CUDA set-up), with the mask kernels' launches on each
    point-to-point path, counted from 0 just before it."""
    out = {"dryrun": graft_entry.dryrun_rank(group, True),
           "probe": probe_data_parallel.rank_main(group, *probe_args)}
    torch.cuda.empty_cache()
    out["coil"] = probe_coil_parallel.rank_main(group, *coil_args)
    torch.cuda.empty_cache()
    train_list, ckpt3d, infer_list, args, pair, work = mp_args
    mp = out["model_parallel"] = {}
    launches = out["launches"] = {}
    reset_mask_launches()
    mp["unet3d"] = probe_model_parallel.unet3d_part(group, train_list, work)
    torch.cuda.empty_cache()
    with f32_on_card(group.device):
        mp["infer3d"] = probe_model_parallel.infer3d_part(
            group, ckpt3d, infer_list, work)
    launches["unet3d_spatial"] = mask_launches()
    reset_mask_launches()
    mp["varnet_pp"] = probe_model_parallel.varnet_pp_part(group, args, pair,
                                                         work)
    launches["varnet_pipeline"] = mask_launches()
    return out


def _sum_launches(ranks: list, path: str) -> dict:
    """A path's mask kernel launches summed over the ranks."""
    out: dict = {}
    for r in ranks:
        for k, n in r["launches"][path].items():
            out[k] = out.get(k, 0) + n
    return out


def phase_data_parallel(dev: torch.device, defaults: dict, tmp: str,
                        ckpt3d: str, list3d: str) -> dict:
    """Phase 15: data and model parallelism on the card's one device, the
    3-D checks on phase 11's checkpoint ``ckpt3d`` and volume list
    ``list3d``. Returns the mask kernels' launches on each of its paths:
    packing its volumes, the spread preprocess, the depth-sharded 3-D
    U-Net and VarNet's pipeline."""
    t0 = time.perf_counter()
    reset_mask_launches()
    train_list, val_list = dp_pack(dev, tmp)
    launches = mask_launches()
    if set(launches.values()) != {DP_VOLUMES}:
        raise AssertionError(f"phase 15 packed {DP_VOLUMES} volumes with "
                             f"{launches} mask kernel launches")
    out = {"launcher_refusal": dp_launcher_refusal(tmp),
           "spread_preprocess": dp_spread_preprocess(dev)}
    with probe_data_parallel.f32_deterministic():
        out["segment"] = dp_segment(dev, val_list)
        out["nccl_world1"] = dp_nccl_world1(dev, train_list, tmp)
        # graft_entry.dryrun_multichip(2)'s ranks, then the probes'
        t1, wall = time.perf_counter(), time.time()
        devices, where = graft_entry.dryrun_devices(2)
        coil_args, pair = probe_model_parallel.protocol_pair()
        coil_case = (pair[0].kspace, pair[0].espirit, pair[0].target,
                     np.float32(pair[0].max_value))
        ranks = mesh.spawn(dp_rank, 2, devices, timeout_s=900.0, args=(
            probe_data_parallel.rank_args(train_list, val_list, tmp),
            (coil_args, coil_case, tmp),
            (train_list, ckpt3d, list3d, coil_args, pair, tmp)))
        out["probe"] = ranks[0]["probe"]
        out["coil_probe"] = ranks[0]["coil"]
        out["model_parallel"] = ranks[0]["model_parallel"]
        one = ranks[1]["model_parallel"]
        out["model_parallel"]["rank1"] = {
            "peak_gib": one["unet3d"]["timing"]["peak_gib_grid_rank"],
            "halo_sends": one["unet3d"]["timing"]["halo_sends"],
            "halo_bytes": one["unet3d"]["timing"]["halo_bytes"],
            "pipe_sends": one["varnet_pp"]["timing"]["sends"],
            "pipe_bytes": one["varnet_pp"]["timing"]["bytes"]}
        p2p = {path: _sum_launches(ranks, path)
               for path in ("unet3d_spatial", "varnet_pipeline")}
        if any(n for counts in p2p.values() for n in counts.values()):
            raise AssertionError(f"a mask kernel ran on a point-to-point "
                                 f"path: {p2p}")
        out["probe"]["part_seconds"]["spawn_to_probe_start"] = (
            out["probe"].pop("started") - wall)
        out["dryrun_multichip"] = graft_entry.dryrun_check(
            [r["dryrun"] for r in ranks], devices, where)
        out["ranks_seconds"] = time.perf_counter() - t1
    if _precision_flags() != defaults:
        _set_precision_flags(defaults)
    timing = out["probe"]["timing"]
    print(f"data parallel, 2 ranks sharing one card over gloo: "
          f"{timing['ms_step_ranks']:.1f} ms a step (1 rank "
          f"{timing['ms_step_one_rank']:.1f} ms), gradient all-reduce "
          f"{timing['ms_allreduce']:.1f} ms for "
          f"{timing['allreduce_bytes']} bytes", flush=True)
    coil = out["coil_probe"]
    print(f"coil parallel, protocol VarNet on a (1, 2) grid over gloo: "
          f"{coil['timing']['ms_step_grid']:.1f} ms a bf16 step (1 rank "
          f"{coil['timing']['ms_step_one_rank']:.1f} ms), "
          f"{coil['timing']['coil_all_reduces']} coil all-reduces a step "
          f"({coil['timing']['coil_bytes']} bytes), f32 step: loss "
          f"{coil['f32']['loss_abs_diff']:.2e} off, gradient drift worst "
          f"{coil['f32']['grad_worst_drift']:.2e} "
          f"({coil['f32']['grad_worst_tensor']}) median "
          f"{coil['f32']['grad_median_drift']:.2e} (coil-order floor "
          f"{coil['f32']['floor_worst_drift']:.2e} / "
          f"{coil['f32']['floor_median_drift']:.2e}), float64 "
          f"{coil['f64']['f64_worst_rel_to_max']:.2e} of a tensor's max "
          f"({coil['f64']['f64_worst_tensor']}); parts "
          f"{coil['part_seconds']}", flush=True)
    mp = out["model_parallel"]
    u, t3 = mp["unet3d"], mp["unet3d"]["timing"]
    print(f"depth-sharded 3-D U-Net {u['channels']} at ROI {u['roi']} "
          f"batch {u['batch']}, 2 ranks over gloo (bands of "
          f"{u['bands'][1]} planes): {t3['ms_step_grid']:.1f} ms a bf16 "
          f"step (1 rank {t3['ms_step_one_rank']:.1f} ms), halo sends a "
          f"step {t3['halo_sends']} / {mp['rank1']['halo_sends']} "
          f"({t3['halo_bytes']} / {mp['rank1']['halo_bytes']} bytes), "
          f"{t3['all_reduces']} depth all-reduces, peak "
          f"{t3['peak_gib_grid_rank']:.2f} / "
          f"{mp['rank1']['peak_gib']:.2f} GiB a rank (1 rank "
          f"{t3['peak_gib_one_rank']:.2f}); forward "
          f"{u['forward']['rel_to_max']:.2e} of max (floor "
          f"{u['forward']['floor_one_ulp']:.2e}), f32 step loss "
          f"{u['f32']['loss_rel_diff']:.2e}, gradient drift worst "
          f"{u['f32']['grad_worst_drift']:.2e} median "
          f"{u['f32']['grad_median_drift']:.2e} (one-ulp floor "
          f"{u['f32']['floor_worst_drift']:.2e} / "
          f"{u['f32']['floor_median_drift']:.2e}), float64 "
          f"{u['f64']['f64_worst_rel_to_max']:.2e}; parts "
          f"{u['part_seconds']}", flush=True)
    for v in mp["infer3d"]["volumes"]:
        print(f"cli.infer --ckpt3d --spatial-parallel 2 on {v['volume']} "
              f"{v['shape']}: {v['differ']} of {v['voxels']} mask voxels "
              f"differ from one rank, {v['differ_outside_margin']} outside "
              f"{v['margin']} of the threshold ({v['within_margin']} "
              f"within); dice {v['dice_sharded']} vs "
              f"{v['dice_one_rank']}; "
              f"{mp['infer3d']['seconds_sharded']:.2f} s vs "
              f"{mp['infer3d']['seconds_one_rank']:.2f} s", flush=True)
    pp, tp = mp["varnet_pp"], mp["varnet_pp"]["timing"]
    print(f"pipelined protocol VarNet, {pp['stages']} stages x "
          f"{pp['microbatches']} microbatches over gloo: "
          f"{tp['ms_step_pipe']:.1f} ms a bf16 step (1 rank "
          f"{tp['ms_step_one_rank']:.1f} ms), sends a step {tp['sends']} / "
          f"{mp['rank1']['pipe_sends']} ({tp['bytes']} / "
          f"{mp['rank1']['pipe_bytes']} bytes), bubble "
          f"{pp['bubble_share']:.3f}; f32 "
          f"step loss {pp['f32']['loss_rel_diff']:.2e}, gradient drift "
          f"worst {pp['f32']['grad_worst_drift']:.2e} median "
          f"{pp['f32']['grad_median_drift']:.2e} (one-ulp floor "
          f"{pp['f32']['floor_worst_drift']:.2e} / "
          f"{pp['f32']['floor_median_drift']:.2e})", flush=True)
    seconds = time.perf_counter() - t0
    print(f"phase 15: {seconds:.1f} s", flush=True)
    emit({"phase": "data_parallel", "seconds": seconds,
          "launches": launches, **out})
    return {"data_parallel": launches,
            "spread_preprocess": out["spread_preprocess"][
                "launches_spread"], **p2p}


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    smi, defaults = phase_setup()
    phase_build()
    row = phase_kernel(dev)
    chain_s = {"preprocess_volume_warm_s": phase_preprocess(dev)}
    model = phase_model(dev)
    serve_launches, chain_s["preprocess_request_s"] = phase_serve(
        model, dev, defaults)
    by_path = {"serve": serve_launches}
    if min(by_path["serve"].values()) < 1:
        raise AssertionError(f"the main path launched a mask kernel no "
                             f"time: {by_path['serve']}")
    with tempfile.TemporaryDirectory() as tmp:
        by_path["train"] = phase_train(dev, defaults, tmp)
        by_path["evaluate_serve"] = phase_evaluate(model, dev, defaults, tmp)
        if set(by_path["evaluate_serve"].values()) != {1}:
            raise AssertionError(f"phase 7 launched the mask kernels "
                                 f"{by_path['evaluate_serve']} times, not "
                                 "once")
        cc_row, prop_row, by_path["multicoil_serve"] = phase_preprocess_rest(
            model, dev, defaults, chain_s)
        by_path.update(phase_rest_2d(dev, defaults, tmp))
        corpus = phase_corpus(dev, defaults, tmp)
        by_path["corpus"] = corpus["launches"]
        by_path["patch3d"] = phase_3d(dev, defaults, tmp, corpus["lists"])
        by_path.update(phase_recon_ingest(dev, defaults, tmp, smi))
        by_path.update(phase_varnet(dev, defaults, tmp))
        by_path.update(phase_classify(dev, defaults, tmp))
        # phase 11's checkpoint and its whole val volume
        by_path.update(phase_data_parallel(
            dev, defaults, tmp,
            os.path.join(tmp, "run3d_host", "best3d.ckpt"),
            os.path.join(tmp, "val3d_one.txt")))
    for r in (row, cc_row):
        r["launches"] = by_path["serve"][r["name"]]
        r["launches_by_path"] = {p: n[r["name"]] for p, n in by_path.items()}
    emit({"kernels": [row, cc_row, prop_row]})
    print(f"chip_smoke.py: {time.perf_counter() - t0:.1f} s", flush=True)
    print(smi, flush=True)
    emit({"total_seconds": time.perf_counter() - t0})
    faulthandler.cancel_dump_traceback_later()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

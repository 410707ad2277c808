"""Served k-space traffic: a closed loop of client threads, each calling
``_ModelRunner.segment_kspace`` in process for whole single-coil volumes
and sending its next request when the last is answered.

Set-up makes a pool of k-space volumes from the seed (``volumes_per_size``
of each slice count in ``slices``), the served model with the
benchmark's weights in ``serve_dtype``, and a
runner as ``cli/serve.py:create_server`` makes one: TF32 off, the mask
kernels' libraries loaded; then the client threads, each of which warms
every slice count before it waits. The window starts the clients
together; request ``i`` sends pool volume ``order[i % len(pool)]``, the
order drawn from the seed, so every seed sends the same sizes. No
request starts after ``seconds``; the window closes when the last one is
answered, and every answered request counts. A sample of the answers,
drawn from the seed and holding one of the longest volumes, is kept and
judged against the plain reference once the program's state is freed.
"""

from __future__ import annotations

import gc
import os
import random
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..counts.flops import flops_per_slice
from ..harness import generator, sub_seed
from ..reference.compare import answer_readings
from ..reference.segment import answer
from ..tracing import Trace
from ..traffic.synthetic import kspace_pairs, load_panels
from ..traffic.weights import make_weights

HERE = Path(__file__).resolve().parent


class _Sample:
    """A reservoir of ``k`` answers drawn by ``rng`` from those completed,
    and the first answer of the longest volumes, kept beside it."""

    def __init__(self, k: int, rng: random.Random, longest: int):
        self.k, self.rng, self.longest = k, rng, longest
        self.kept: list = []
        self.seen = 0
        self.long = None

    def offer(self, item: dict) -> None:
        if self.long is None and item["slices"] == self.longest:
            self.long = item
        if self.seen < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = item
        self.seen += 1

    def answers(self) -> list:
        if self.long is not None and all(a["slices"] != self.longest
                                         for a in self.kept):
            return self.kept + [self.long]
        return list(self.kept)


def run(cell: dict, seed: int, seconds: float, trace: bool,
        dev: torch.device, t_start: float, control: bool = False) -> dict:
    from mri_acl_imagesegmentation_adsp_tpu_torch.cli.infer import (
        model_apply_fn)
    from mri_acl_imagesegmentation_adsp_tpu_torch.cli.serve import (
        _ModelRunner)
    from mri_acl_imagesegmentation_adsp_tpu_torch.models.factory import (
        build_unet)
    from mri_acl_imagesegmentation_adsp_tpu_torch.ops.kernels import (
        components, morphology)
    from mri_acl_imagesegmentation_adsp_tpu_torch.utils.device import (
        f32_on_card)
    from mri_acl_imagesegmentation_adsp_tpu_torch.utils.imagenet import (
        make_input_norm)

    cfg, tr = cell["config"], cell["traffic"]
    h, w = tr["kspace_hw"]
    out_hw = int(cfg["image_size"])
    thr = float(tr["threshold"])
    gen = generator(seed, 0, dev)
    sizes = [int(s) for s in tr["slices"]
             for _ in range(tr["volumes_per_size"])]
    panels = load_panels(HERE.parent / tr["panels"], dev)
    pool = [kspace_pairs(gen, panels, s, h, w).cpu().numpy() for s in sizes]
    del panels

    params, stats = make_weights(cfg["model"], generator(seed, 1, dev))
    with torch.device(dev):
        model = build_unet(cfg["model"], cfg["encoder"], in_ch=1, classes=1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
        for name, (mean, var) in stats.items():
            model.get_buffer(name + ".running_mean").copy_(mean)
            model.get_buffer(name + ".running_var").copy_(var)
    model.compute_dtype = getattr(torch, cfg["serve_dtype"])
    model.eval()
    runner = _ModelRunner(
        model_apply_fn(model, make_input_norm(False)), 1, 1, "benchmark",
        int(tr["batch_size"]), pre_out_size=(out_hw, out_hw), device=dev,
        compute_dtype=model.compute_dtype)
    runner._on_close.enter_context(f32_on_card(dev))
    if dev.type == "cuda":
        morphology.load_library()
        components.load_library()
    order = list(range(len(pool)))
    random.Random(sub_seed(seed, 2)).shuffle(order)
    sample = _Sample(int(tr["checked_answers"]),
                     random.Random(sub_seed(seed, 3)), max(sizes))
    lock = threading.Lock()
    state = {"next": 0, "failed": 0, "deadline": 0.0}
    lat, done = [], []
    warm = threading.Barrier(int(tr["clients"]) + 1)
    go = threading.Event()

    def client() -> None:
        # each client thread warms its own per-thread state (cuDNN and
        # cuBLAS handles, their plans) on every slice count, then waits
        try:
            for s in sorted(set(sizes)):
                for _ in range(2):
                    runner.segment_kspace(pool[sizes.index(s)], thr, False)
        except BaseException:
            warm.abort()
            raise
        warm.wait()
        go.wait()
        while True:
            with lock:
                if time.perf_counter() >= state["deadline"]:
                    return
                i = state["next"]
                state["next"] += 1
            v = order[i % len(pool)]
            t = time.perf_counter()
            try:
                with torch.profiler.record_function("bench::request"):
                    ans = runner.segment_kspace(pool[v], thr, False)
            except Exception as exc:   # counted as failed; the loop goes on
                print(f"request {i} failed: {exc!r}", file=sys.stderr,
                      flush=True)
                with lock:
                    state["failed"] += 1
                continue
            t1 = time.perf_counter()
            with lock:
                lat.append(t1 - t)
                done.append(t1)
                sample.offer({"volume": v, "slices": sizes[v],
                              "mask": ans["mask"],
                              "body_mask": ans["body_mask"],
                              "indices": ans["indices"]})

    threads = [threading.Thread(target=client)
               for _ in range(int(tr["clients"]))]
    for t in threads:
        t.start()
    warm.wait(timeout=600)
    with runner.stats_lock:
        runner.requests = runner.slices = 0
        runner.seconds = 0.0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.time() - t_start

    with Trace(trace) as tr_:
        with tr_.window():
            t0, cpu0 = time.perf_counter(), os.times()
            state["deadline"] = t0 + seconds
            go.set()
            for t in threads:
                t.join()
            window_s = max(done) - t0 if done else time.perf_counter() - t0
            cpu1 = os.times()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    reduced = tr_.reduce()
    with runner.stats_lock:
        locked_s, served, slices = (runner.seconds, runner.requests,
                                    runner.slices)
    served_sizes = [sizes[order[i % len(pool)]] for i in range(state["next"])]
    runner.close()
    del runner, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    answers = sample.answers()
    vols = sorted({a["volume"] for a in answers})
    refs = {v: answer(cfg["model"], params, stats,
                      torch.from_numpy(pool[v]).to(dev), out_hw) for v in vols}
    n = len(lat)
    out = {
        "setup_s": setup_s,
        "e2e": {"kspace_volumes_per_s": n / window_s},
        "readings": answer_readings(answers, refs),
        "attempted": n + state["failed"], "failed": state["failed"],
        "memory_peak_bytes": peak, "trace": reduced,
        "ctx": {"window_s": window_s, "requests": served, "slices": slices,
                "locked_s": locked_s,
                "p95_ms": float(np.percentile(lat, 95)) * 1e3 if lat
                else None,
                "flops_per_slice": flops_per_slice(cfg["model"], out_hw,
                                                   out_hw, False),
                "mask_shapes": [(s, h, w) for s in served_sizes]},
        "counts": {"requests": n, "failed": state["failed"],
                   "slices": slices, "window_s": window_s,
                   "p50_ms": float(np.percentile(lat, 50)) * 1e3 if lat
                   else None,
                   "p95_ms": float(np.percentile(lat, 95)) * 1e3 if lat
                   else None,
                   "locked_s": locked_s,
                   "cpu_s": (cpu1.user + cpu1.system) - (cpu0.user
                                                         + cpu0.system),
                   "host_threads": torch.get_num_threads(),
                   "checked_answers": len(answers), "reference_s": 0.0,
                   "answered_by_second": np.bincount(
                       (np.asarray(done) - t0).astype(int)).tolist()
                   if done else []},
    }
    if control:
        ctl = []
        for v in vols:
            c = answer(cfg["model"], params, stats,
                       torch.from_numpy(pool[v]).to(dev), out_hw, control=True)
            ctl.append({"volume": v, "mask": (c["logits"] > 0).to(torch.uint8),
                        "body_mask": c["body_mask"].to(torch.uint8),
                        "indices": np.arange(sizes[v])})
        out["control_readings"] = answer_readings(ctl, refs)
    out["counts"]["reference_s"] = time.perf_counter() - t_ref
    return out

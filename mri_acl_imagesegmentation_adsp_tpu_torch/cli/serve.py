"""Segmentation serving daemon over HTTP.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/cli/serve.py``:
``_MicroBatcher`` (:83-165), ``_ModelRunner`` (:168-311), ``_Handler``
(:520-660), ``create_server`` and ``main``. The process loads a checkpoint
once and answers whole-volume requests on one device:

  GET  /healthz            -> JSON {status, task, k, classes, source,
                                    requests}
  GET  /metricsz           -> Prometheus text: requests, slices, errors,
                              busy seconds, last latency
  POST /v1/segment         body: .npz with "img" ((S,H,W) or (S,1,H,W)
                           float32, preprocessed as in training)
                           query: ?threshold=0.5, ?probs=1
                           -> .npz {mask uint8 (S,H,W) [, probs (S,C,H,W)]}
  POST /v1/segment_kspace  body: .npz with "kspace", single-coil (S,H,W,2)
                           or multi-coil (S,C,H,W,2) float32 real pair; the
                           preprocess chain (iFFT, per coil then RSS for
                           multi-coil, clip, body mask, resize, z-score)
                           runs in front of the model
                           query: ?threshold, ?probs, ?keep=lo,hi (slice
                           keep band, default 0,1 = every slice)
                           -> .npz {mask, body_mask uint8, indices int64
                                    [, probs]}

``--tta hflip`` serves the mean probability over the horizontal-flip orbit
(``infer/segment.py:tta_wrap``). ``--microbatch-window-ms`` coalesces
``/v1/segment`` requests that arrive within the window into one run of
batches (``segment_volumes_2d``) on a dispatcher thread that owns the
device; each request gets its own result, equal to the per-request path up
to the batch composition. Bad input answers 400, any other failure 500. Not
ported (``main`` has no flag for them): quantized artifacts (--qtree), data
parallelism, and the recon and classify tasks.

Usage:
  python -m mri_acl_imagesegmentation_adsp_tpu_torch.cli.serve \\
      --ckpt best.ckpt --port 8080 [--device cuda] \\
      [--warmup-shape 8,320,320] [--tta hflip] [--microbatch-window-ms 5]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import threading
import time
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..data.preprocess import MRIKneePreprocessor
from ..infer.segment import (segment_volume_2d, segment_volumes_2d,
                             threshold_probs, tta_wrap)
from ..ops.kernels import morphology
from ..utils.device import f32_on_card, resolve_device
from ..utils.imagenet import make_input_norm
from .infer import load_model_from_ckpt


class _MicroBatcher:
    """Coalesces concurrent ``/v1/segment`` requests into one run of batches.

    The first request to arrive waits ``window_ms`` for followers; then up
    to ``max_group`` pending requests are grouped by ``(H, W)`` and
    threshold mode and each group is segmented in one
    ``_ModelRunner.segment_many`` call. One dispatcher thread owns the
    device; handler threads block on their request's event. When a group
    fails, its requests are retried one by one, so a poisoned request fails
    only itself."""

    def __init__(self, runner: "_ModelRunner", window_ms: float = 5.0,
                 max_group: int = 64):
        self.runner = runner
        self.window = max(0.0, float(window_ms)) / 1000.0
        self.max_group = int(max_group)
        self._cv = threading.Condition()
        self._pending: list = []
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-microbatch")
        self._thread.start()

    class _Item:
        __slots__ = ("vol", "thr", "event", "out", "exc")

        def __init__(self, vol, thr):
            self.vol = vol
            self.thr = thr          # None: probabilities; else mask only
            self.event = threading.Event()
            self.out = None
            self.exc = None

    def submit(self, vol: np.ndarray, thr=None) -> np.ndarray:
        """Blocking: ``(S, C, H, W)`` probabilities (``thr`` None) or the
        ``(S, H, W)`` uint8 mask thresholded on the device."""
        it = self._Item(vol, thr)
        with self._cv:
            if self._closed:
                raise RuntimeError("the micro-batcher is closed")
            self._pending.append(it)
            self._cv.notify()
        it.event.wait()
        if it.exc is not None:
            raise it.exc
        return it.out

    def close(self, timeout: float = 30.0) -> None:
        """Stop the dispatcher once the pending requests are answered."""
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending:
                    return
            if self.window:
                time.sleep(self.window)     # the bounded coalescing wait
            with self._cv:
                group = self._pending[:self.max_group]
                self._pending = self._pending[self.max_group:]
            by_key: dict = {}
            for it in group:
                by_key.setdefault((tuple(it.vol.shape[-2:]), it.thr),
                                  []).append(it)
            for (_, thr), items in by_key.items():
                self._dispatch(items, thr)

    def _dispatch(self, items: list, thr) -> None:
        try:
            outs = self.runner.segment_many([it.vol for it in items], thr)
            for it, out in zip(items, outs):
                it.out = out
        except Exception:                   # noqa: BLE001
            # retry one by one: only the poisoned request fails
            for it in items:
                try:
                    it.out = self.runner.segment_many([it.vol], thr)[0]
                except Exception as exc:    # noqa: BLE001
                    it.exc = exc
        finally:
            for it in items:                # no handler waits forever
                it.event.set()


class _ModelRunner:
    """Owns the model's apply function and metadata; serializes the device."""

    task = "segment"

    def __init__(self, apply_fn, k: int, classes: int, source: str,
                 batch_size: int, pre_out_size=(320, 320),
                 device: str | torch.device = "cuda",
                 microbatch_window_ms: float = 0.0):
        self.apply_fn = apply_fn
        self.k = k
        self.classes = classes
        self.source = source
        self.batch_size = batch_size
        self.device = resolve_device(device)
        # resize target of the /v1/segment_kspace chain: the resolution the
        # served model was trained at
        self.pre_out_size = tuple(int(v) for v in pre_out_size)
        self.requests = 0
        self.slices = 0
        self.errors = 0
        self.seconds = 0.0
        self.last_latency_s = 0.0
        self._lock = threading.Lock()        # serializes the device
        self.stats_lock = threading.Lock()   # guards the counters only
        self._pres: dict = {}                # preprocessor per keep band
        self._on_close = contextlib.ExitStack()  # undone by close()
        # /v1/segment requests coalesce on a dispatcher thread when the
        # window is above 0, instead of queueing on the lock
        self.batcher = (_MicroBatcher(self, microbatch_window_ms)
                        if microbatch_window_ms > 0 else None)

    def close(self) -> None:
        if self.batcher is not None:
            self.batcher.close()
        self._on_close.close()

    def count_error(self) -> None:
        with self.stats_lock:
            self.errors += 1

    def _record(self, t0: float, n_slices: int, n_requests: int = 1) -> None:
        dt = time.perf_counter() - t0
        with self.stats_lock:
            self.last_latency_s = dt
            self.seconds += dt
            self.requests += n_requests
            self.slices += n_slices

    def segment_many(self, vols, mask_threshold=None) -> list:
        """One run of batches for a group of volumes (a single volume on the
        path without micro-batching): ``[(S_i, C, H, W)]`` float32
        probabilities, or ``[(S_i, H, W)]`` uint8 masks thresholded on the
        device when ``mask_threshold`` is set. Each volume counts as one
        request."""
        with self._lock:
            t0 = time.perf_counter()
            xs = [torch.from_numpy(np.ascontiguousarray(v, np.float32)
                                   ).to(self.device) for v in vols]
            outs = segment_volumes_2d(self.apply_fn, xs, k=self.k,
                                      batch_size=self.batch_size,
                                      classes=self.classes,
                                      masks_only_threshold=mask_threshold)
            outs = [o.cpu().numpy() for o in outs]
            self._record(t0, sum(int(x.shape[0]) for x in xs), len(vols))
        return outs

    def segment(self, vol: np.ndarray, threshold: float,
                want_probs: bool) -> dict:
        if vol.ndim not in (3, 4):
            raise ValueError(f"img must be (S,H,W) or (S,1,H,W), "
                             f"got shape {vol.shape}")
        # mask only (the default request): thresholded on the device, so
        # S*H*W uint8 come back instead of the probabilities
        thr = None if want_probs else float(threshold)
        out = (self.batcher.submit(vol, thr) if self.batcher is not None
               else self.segment_many([vol], thr)[0])
        if not want_probs:
            return {"mask": out}
        return {"mask": threshold_probs(torch.from_numpy(out), self.classes,
                                        threshold).numpy(),
                "probs": out}

    def segment_kspace(self, kpair: np.ndarray, threshold: float,
                       want_probs: bool, slice_keep=(0.0, 1.0)) -> dict:
        """Raw single-coil ``(S,H,W,2)`` or multi-coil ``(S,C,H,W,2)``
        k-space -> preprocess chain -> model, one request. The model sees
        exactly the z-scored tensor training consumed; the response also
        carries the body mask and the kept slice indices."""
        band = tuple(float(v) for v in slice_keep)
        pre = self._pres.get(band)
        if pre is None:
            pre = self._pres.setdefault(band, MRIKneePreprocessor(
                out_size=self.pre_out_size, slice_keep=band,
                device=self.device))
        with self._lock:
            t0 = time.perf_counter()
            packed = pre.preprocess_volume_pairs(kpair)
            probs = segment_volume_2d(self.apply_fn, packed["tensor"],
                                      k=self.k, batch_size=self.batch_size,
                                      classes=self.classes)
            out = {"mask": threshold_probs(probs, self.classes, threshold
                                           ).cpu().numpy(),
                   "body_mask": packed["mask"].cpu().numpy(),
                   "indices": np.asarray(packed["indices"], np.int64)}
            if want_probs:
                out["probs"] = probs.cpu().numpy()
            self._record(t0, len(packed["indices"]))
        return out

    def warmup(self, shape) -> None:
        """Run the mask and probs paths once at the production shape; the
        warm-up is not a served request, so the counters restart at 0."""
        self.segment(np.zeros(shape, np.float32), 0.5, False)
        self.segment(np.zeros(shape, np.float32), 0.5, True)
        with self.stats_lock:
            self.requests = self.slices = 0
            self.seconds = self.last_latency_s = 0.0


def _build_runner(args) -> _ModelRunner:
    device = resolve_device(getattr(args, "device", "cuda"))
    model, margs = load_model_from_ckpt(args.ckpt, device)
    norm = make_input_norm(bool(margs.get("imagenet_norm")))
    classes = int(margs.get("classes", 1))

    def apply_fn(x):
        return model(norm(x))

    pre_out = tuple(int(v) for v in str(
        getattr(args, "pre_out_size", "") or "320,320").split(","))
    return _ModelRunner(
        tta_wrap(apply_fn, classes, getattr(args, "tta", "none") or "none"),
        int(margs.get("k", 1)), classes, "ckpt", args.batch_size,
        pre_out_size=pre_out, device=device,
        microbatch_window_ms=float(
            getattr(args, "microbatch_window_ms", 0.0) or 0.0))


class _Handler(BaseHTTPRequestHandler):
    runner: _ModelRunner = None   # set on the subclass by create_server

    def log_message(self, fmt, *a):  # quiet: stdout is the API
        pass

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        r = self.runner
        path = urlparse(self.path).path
        if path == "/healthz":
            return self._json(200, {"status": "ok", "task": r.task,
                                    "k": r.k, "classes": r.classes,
                                    "source": r.source,
                                    "requests": r.requests})
        if path == "/metricsz":
            with r.stats_lock:
                body = (
                    "# TYPE serve_requests_total counter\n"
                    f"serve_requests_total {r.requests}\n"
                    "# TYPE serve_slices_total counter\n"
                    f"serve_slices_total {r.slices}\n"
                    "# TYPE serve_errors_total counter\n"
                    f"serve_errors_total {r.errors}\n"
                    "# TYPE serve_busy_seconds_total counter\n"
                    f"serve_busy_seconds_total {r.seconds:.6f}\n"
                    "# TYPE serve_last_latency_seconds gauge\n"
                    f"serve_last_latency_seconds {r.last_latency_s:.6f}\n"
                ).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            return self.wfile.write(body)
        return self._json(404, {"error": "unknown path"})

    def do_POST(self):
        url = urlparse(self.path)
        if url.path not in ("/v1/segment", "/v1/segment_kspace"):
            return self._json(404, {"error": "unknown path"})
        try:
            n = int(self.headers.get("Content-Length", 0))
            q = parse_qs(url.query)
            threshold = float(q.get("threshold", ["0.5"])[0])
            want_probs = q.get("probs", ["0"])[0] in ("1", "true")
            with np.load(io.BytesIO(self.rfile.read(n)),
                         allow_pickle=False) as z:
                if url.path == "/v1/segment_kspace":
                    if "kspace" not in z:
                        raise ValueError(
                            "npz body must contain array 'kspace'")
                    keep = q.get("keep", ["0,1"])[0].split(",")
                    if len(keep) != 2:
                        raise ValueError("keep must be 'lo,hi'")
                    out = self.runner.segment_kspace(
                        z["kspace"], threshold, want_probs,
                        slice_keep=(float(keep[0]), float(keep[1])))
                else:
                    if "img" not in z:
                        raise ValueError("npz body must contain array 'img'")
                    out = self.runner.segment(z["img"], threshold,
                                              want_probs)
        except (ValueError, zipfile.BadZipFile) as exc:
            # client-input errors: bad npz, missing arrays, bad shapes
            self.runner.count_error()
            return self._json(400, {"error": str(exc)})
        except Exception as exc:  # device or shape errors go to the client
            self.runner.count_error()
            return self._json(500, {"error": f"{type(exc).__name__}: {exc}"})
        buf = io.BytesIO()
        np.savez_compressed(buf, **out)
        body = buf.getvalue()
        self.send_response(200)
        self.send_header("Content-Type", "application/x-npz")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def create_server(args) -> ThreadingHTTPServer:
    """Load and warm the model, build the CUDA kernels the path runs, and
    bind the server (``args.port=0`` binds a free port). Split from
    ``main`` so a caller can drive it in-process.

    The daemon serves f32: on a card it turns TF32 off for the process's
    convolutions and matmuls (``utils/device.py:f32_on_card``) until its
    runner is closed, which puts the caller's flags back."""
    runner = _build_runner(args)
    runner._on_close.enter_context(f32_on_card(runner.device))
    if runner.device.type == "cuda":
        morphology.load_library()    # build before the first request
    if getattr(args, "warmup_shape", ""):
        runner.warmup(tuple(int(v) for v in args.warmup_shape.split(",")))
    handler = type("BoundHandler", (_Handler,), {"runner": runner})
    server = ThreadingHTTPServer((args.host, args.port), handler)
    # graceful drain: server_close() joins in-flight handler threads after
    # shutdown() stops new accepts
    server.daemon_threads = False
    server.block_on_close = True
    return server


def install_drain_handler(server) -> None:
    """SIGTERM -> stop accepting, let in-flight requests finish, exit.
    ``shutdown()`` must run off the ``serve_forever`` thread."""
    import signal

    def _drain(*_):
        print(json.dumps({"draining": True}), flush=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _drain)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "Segmentation serving daemon (PyTorch)",
        epilog="Not ported, so refused as unrecognized arguments: the JAX "
               "daemon's --task, --qtree and --data-parallel.")
    p.add_argument("--ckpt", required=True,
                   help="best checkpoint (train/checkpoint.py format) with "
                        "its .args.json beside it")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--pre-out-size", default="320,320",
                   help="'H,W' resize target of the /v1/segment_kspace "
                        "chain: the resolution the model was trained at")
    p.add_argument("--warmup-shape", default="",
                   help="'S,H,W' to run once before accepting requests")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises")
    p.add_argument("--tta", choices=("none", "hflip"), default="none",
                   help="serve the mean probability over the horizontal-"
                        "flip orbit (2x device compute a request)")
    p.add_argument("--microbatch-window-ms", type=float, default=0.0,
                   help="coalesce /v1/segment requests arriving within this "
                        "window into one run of batches (0 = off; try 5 "
                        "under concurrent load)")
    args = p.parse_args(argv)

    server = create_server(args)
    install_drain_handler(server)
    host, port = server.server_address[:2]
    device = server.RequestHandlerClass.runner.device
    print(json.dumps({"serving": f"http://{host}:{port}", "source": "ckpt",
                      "device": str(device)}), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        server.RequestHandlerClass.runner.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

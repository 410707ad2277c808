"""Segmentation serving daemon over HTTP.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/cli/serve.py``:
``_ModelRunner.segment`` / ``.segment_kspace`` / ``.warmup`` (:233-300),
``_Handler`` (:520-615), ``create_server`` and ``main``. The process loads a
checkpoint once and answers whole-volume requests on one device:

  GET  /healthz            -> JSON {status, task, k, classes, source,
                                    requests}
  POST /v1/segment         body: .npz with "img" ((S,H,W) or (S,1,H,W)
                           float32, preprocessed as in training)
                           query: ?threshold=0.5, ?probs=1
                           -> .npz {mask uint8 (S,H,W) [, probs (S,C,H,W)]}
  POST /v1/segment_kspace  body: .npz with "kspace", single-coil (S,H,W,2)
                           float32 real pair; the preprocess chain (iFFT,
                           clip, body mask, resize, z-score) runs in front
                           of the model
                           query: ?threshold, ?probs, ?keep=lo,hi (slice
                           keep band, default 0,1 = every slice)
                           -> .npz {mask, body_mask uint8, indices int64
                                    [, probs]}

Bad input answers 400, any other failure 500. Not ported yet (``main``
has no flag for them): /metricsz, micro-batching, quantized artifacts (--qtree),
test-time augmentation, data parallelism, multi-coil k-space, and the recon
and classify tasks.

Usage:
  python -m mri_acl_imagesegmentation_adsp_tpu_torch.cli.serve \\
      --ckpt best.ckpt --port 8080 [--device cuda] [--warmup-shape 8,320,320]
"""

from __future__ import annotations

import argparse
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
from ..infer.segment import segment_volume_2d, threshold_probs
from ..ops.kernels import morphology
from ..utils.device import resolve_device
from ..utils.imagenet import make_input_norm
from .infer import load_model_from_ckpt


class _ModelRunner:
    """Owns the model's apply function and metadata; serializes the device."""

    task = "segment"

    def __init__(self, apply_fn, k: int, classes: int, source: str,
                 batch_size: int, pre_out_size=(320, 320),
                 device: str | torch.device = "cuda"):
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

    def count_error(self) -> None:
        with self.stats_lock:
            self.errors += 1

    def _record(self, t0: float, n_slices: int) -> None:
        dt = time.perf_counter() - t0
        with self.stats_lock:
            self.last_latency_s = dt
            self.seconds += dt
            self.requests += 1
            self.slices += n_slices

    def segment(self, vol: np.ndarray, threshold: float,
                want_probs: bool) -> dict:
        if vol.ndim not in (3, 4):
            raise ValueError(f"img must be (S,H,W) or (S,1,H,W), "
                             f"got shape {vol.shape}")
        with self._lock:
            t0 = time.perf_counter()
            x = torch.from_numpy(np.ascontiguousarray(vol, np.float32)
                                 ).to(self.device)
            probs = segment_volume_2d(self.apply_fn, x, k=self.k,
                                      batch_size=self.batch_size,
                                      classes=self.classes)
            # threshold on the device: S*H*W uint8 come back, and the
            # probabilities only when asked for
            out = {"mask": threshold_probs(probs, self.classes, threshold
                                           ).cpu().numpy()}
            if want_probs:
                out["probs"] = probs.cpu().numpy()
            self._record(t0, int(x.shape[0]))
        return out

    def segment_kspace(self, kpair: np.ndarray, threshold: float,
                       want_probs: bool, slice_keep=(0.0, 1.0)) -> dict:
        """Raw single-coil k-space -> preprocess chain -> model, one request.
        The model sees exactly the z-scored tensor training consumed; the
        response also carries the body mask and the kept slice indices."""
        if kpair.ndim == 5:
            raise ValueError("multi-coil (S,C,H,W,2) k-space is not ported "
                             "yet; send single-coil (S,H,W,2)")
        if kpair.ndim != 4 or kpair.shape[-1] != 2:
            raise ValueError(f"kspace must be (S,H,W,2) real-pair, got "
                             f"shape {kpair.shape}")
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

    def apply_fn(x):
        return model(norm(x))

    pre_out = tuple(int(v) for v in str(
        getattr(args, "pre_out_size", "") or "320,320").split(","))
    return _ModelRunner(apply_fn, int(margs.get("k", 1)),
                        int(margs.get("classes", 1)), "ckpt",
                        args.batch_size, pre_out_size=pre_out, device=device)


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
        if urlparse(self.path).path == "/healthz":
            return self._json(200, {"status": "ok", "task": r.task,
                                    "k": r.k, "classes": r.classes,
                                    "source": r.source,
                                    "requests": r.requests})
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
    convolutions and matmuls, which torch's defaults would run in TF32."""
    runner = _build_runner(args)
    if runner.device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
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
        epilog="Not ported yet, so refused as unrecognized arguments: the "
               "JAX daemon's --task, --qtree, --tta, --data-parallel and "
               "--microbatch-window-ms.")
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

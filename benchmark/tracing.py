"""The profiler over a measured window, reduced to what the metrics read.

``Trace`` wraps ``torch.profiler.profile`` (CPU and CUDA activities). The
window is the ``bench::window`` range recorded around the measured work,
so host and device times share the trace's clock. The reduction keeps:

* ``busy_s``: the length of the union of every device activity (kernels,
  copies, sets; not the annotations that mirror host ranges) clipped to
  the window: the time some operation ran;
* ``device_time_by_name``: their device seconds summed by name;
* ``device_ops``: device time summed by name, the ten largest;
* ``idle_gaps``: the ten longest gaps of that union inside the window,
  each named by the innermost host range open at its middle.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

WINDOW = "bench::window"
NAME_CHARS = 160     # a C++ kernel name's first characters name it enough


def _times(ev) -> Tuple[int, int]:
    """``(start, end)`` of a kineto event in ns."""
    if hasattr(ev, "start_ns"):
        start = int(ev.start_ns())
        return start, start + int(ev.duration_ns())
    start = int(ev.start_us() * 1000)
    return start, start + int(ev.duration_us() * 1000)


class Trace:
    """``with Trace(on) as tr: with tr.window(): ...``; then
    ``tr.reduce()``. Off, it records nothing and reduces to ``None``."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def __enter__(self):
        if self.on:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def window(self):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(WINDOW)

    def reduce(self) -> dict | None:
        if self.prof is None:
            return None
        win = None
        dev, host = [], []
        cuda = torch.autograd.DeviceType.CUDA
        raw = [(ev.name(), *_times(ev), ev.device_type() == cuda)
               for ev in self.prof.profiler.kineto_results.events()]
        # a host range (record_function) is mirrored on the device's
        # timeline as an annotation, under the same name: not an operation
        ranges = {name for name, _, _, on_device in raw if not on_device}
        for name, t0, t1, on_device in raw:
            if on_device:
                if name not in ranges:
                    dev.append((name, t0, t1))
            else:
                if name == WINDOW:
                    win = (t0, t1)
                host.append((name, t0, t1))
        if win is None:
            raise RuntimeError("no measured window in the trace")
        return reduce_events(dev, host, win)


def reduce_events(dev: List[Tuple[str, int, int]],
                  host: List[Tuple[str, int, int]],
                  win: Tuple[int, int]) -> dict:
    """The reduction of device and host events ``(name, start_ns,
    end_ns)`` over the window ``(start_ns, end_ns)``."""
    w0, w1 = win
    clipped = [(n, max(a, w0), min(b, w1)) for n, a, b in dev
               if b > w0 and a < w1]
    by_name: Dict[str, float] = defaultdict(float)
    for n, a, b in clipped:
        by_name[n] += (b - a) * 1e-9
    spans = sorted((a, b) for _, a, b in clipped if b > a)
    union: List[List[int]] = []
    for a, b in spans:
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    busy = sum(b - a for a, b in union) * 1e-9
    edges = [w0] + [t for ab in union for t in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]
    hn = [n for n, _, _ in host if n != WINDOW]
    hs = np.array([a for n, a, _ in host if n != WINDOW], dtype=np.int64)
    he = np.array([b for n, _, b in host if n != WINDOW], dtype=np.int64)
    idle = []
    for a, b in gaps:
        mid = (a + b) // 2
        open_ = np.nonzero((hs <= mid) & (he >= mid))[0]
        name = ("host (no range open)" if open_.size == 0 else
                hn[int(open_[np.argmin(he[open_] - hs[open_])])])
        idle.append([name, (b - a) * 1e-9])
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy,
            "device_time_by_name": dict(by_name),
            "device_ops": [[n[:NAME_CHARS], s] for n, s in top],
            "idle_gaps": idle}

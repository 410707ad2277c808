"""Time work on an NVIDIA card by CUDA events, with the host out of the window.

A start event recorded on an idle card waits for nothing, so the host's time
to enqueue the work after it lands inside the window. :func:`cuda_ms` keeps
the card busy instead, as ``triton.testing.do_bench`` does: before each start
event the card sleeps (``torch.cuda._sleep``) for at least twice the time the
host takes to enqueue the timed function, and a cold timing first zeroes a
256 MB buffer, which evicts the H100's 50 MB L2. It checks, each run, that the
host finished enqueuing the end event before the sleep could have ended, and
sleeps longer if it did not.
"""

from __future__ import annotations

import re
import time
from functools import lru_cache

import numpy as np
import torch

FLUSH_BYTES = 256 << 20   # cold timings zero this much: 5x an H100's L2
MIN_SLEEP_US = 50.0
HOST_MARGIN = 2.0         # the sleep lasts this many times the host's enqueue


@lru_cache(maxsize=None)
def sleep_cycles_per_us() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per microsecond of card time,
    from the fastest of a few 1 ms sleeps: a slower clock only makes a sleep
    of ``us * sleep_cycles_per_us()`` cycles last longer."""
    cycles = 2_000_000
    torch.cuda._sleep(cycles)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return cycles / min(times)


def cuda_ms(fn, cold: bool, iters: int = 50) -> dict:
    """Median milliseconds of ``fn`` on the card over ``iters`` runs, by CUDA
    events, with the host out of the window.

    Each run starts on an idle card: (``cold``: zero a 256 MB buffer,) sleep,
    start event, ``fn``, end event. The sleep lasts ``HOST_MARGIN`` times the
    longest host time of ``fn`` in five calls, at least ``MIN_SLEEP_US``. A run
    is late when the host took longer, from the sleep's enqueue to the end
    event's, than the sleep lasts: then the card may have waited for the host
    inside the window. Any late run doubles the sleep and times all runs
    again, at most three times. Returns ``{"ms", "sleep_us", "late_runs"}``,
    ``late_runs`` those of the last attempt (0 when the window held no host
    time)."""
    flush = (torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
             if cold else None)
    enqueue_s = []
    for i in range(8):
        t = time.perf_counter()
        fn()
        if i >= 3:   # the first calls warm caches and allocators up
            enqueue_s.append(time.perf_counter() - t)
    sleep_us = max(MIN_SLEEP_US, HOST_MARGIN * 1e6 * max(enqueue_s))
    for _ in range(3):
        cycles = int(sleep_us * sleep_cycles_per_us())
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        late = 0
        for start, end in events:
            torch.cuda.synchronize()
            if cold:
                flush.zero_()
            t = time.perf_counter()
            torch.cuda._sleep(cycles)
            start.record()
            fn()
            end.record()
            late += (time.perf_counter() - t) * 1e6 >= sleep_us
        torch.cuda.synchronize()
        if not late:
            break
        sleep_us *= 2
    ms = float(np.median([s.elapsed_time(e) for s, e in events]))
    return {"ms": ms, "sleep_us": sleep_us, "late_runs": late}


def host_us(fn, iters: int = 200) -> float:
    """Median microseconds the host spends in one call of ``fn`` (the
    enqueue, not the card's work)."""
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def _trace(fn, runs: int, pad_s: float) -> dict:
    """Launches and card microseconds of each CUDA kernel, by its name, in a
    ``torch.profiler`` trace of ``runs`` calls that follows a warm-up cycle
    of ``runs`` calls; the host waits ``pad_s`` at each edge of the cycles,
    where a trace can miss kernels."""
    from torch.profiler import ProfilerActivity, profile, schedule
    traced = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traced.extend(p.key_averages())
                 ) as prof:
        for _ in range(2):
            time.sleep(pad_s)
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad_s)
            prof.step()
    out = {}
    for ev in traced:
        step = ev.key.startswith("ProfilerStep")   # the schedule's own span
        if ev.device_time_total > 0 and not step:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = re.split(r"[(<]", name, maxsplit=1)[0].split()[-1]
            name = name.rsplit("::", 1)[-1]
            n, us = out.get(name, (0, 0.0))
            out[name] = (n + ev.count, us + ev.device_time_total)
    return out


def kernel_trace(fn, runs: int = 10, attempts: int = 3,
                 pad_s: float = 0.02) -> dict:
    """The CUDA kernels a call of ``fn`` launches, from a profiler trace of
    ``runs`` calls: ``kernel_us``, the mean card microseconds of one launch
    of each kernel, by its name, and ``kernels_per_call``, the launches the
    trace saw over ``runs``. Every call launches the same kernels, so a
    trace in which a kernel's launches are not a multiple of ``runs`` has
    missed some: it is taken again, up to ``attempts`` traces, and
    ``complete`` says whether the last one saw them all."""
    for _ in range(attempts):
        seen = _trace(fn, runs, pad_s)
        complete = bool(seen) and all(n % runs == 0 for n, _ in
                                      seen.values())
        if complete:
            break
    return {"kernel_us": {k: us / n for k, (n, us) in seen.items()},
            "kernels_per_call": sum(n for n, _ in seen.values()) / runs,
            "trace_complete": complete}

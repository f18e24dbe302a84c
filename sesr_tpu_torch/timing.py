"""Median time of a call: CUDA events on the card, the host clock on the CPU
(where it is a time of PyTorch's CPU kernels, never of the card); and a
call's device busy time from torch.profiler."""

from __future__ import annotations

import time

import numpy as np
import torch


def median_ms(fn, device: torch.device, reps: int, warmup: int = 1,
              lead_ms: float = 0.0) -> float:
    """Median milliseconds of fn() over ``reps`` calls, after ``warmup``.

    On the card with ``lead_ms`` = 0 the calls are enqueued back to back,
    each between two CUDA events: the time as the host issues them, its
    launch rate included. With ``lead_ms`` > 0 each call waits for the
    device, which is then kept busy for about ``lead_ms``
    (torch.cuda._sleep) while the host enqueues the start event, fn's
    launches and the end event: the device's time for fn alone."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))
    torch.cuda.synchronize(device)
    events = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if lead_ms > 0:
            torch.cuda._sleep(int(lead_ms * 2e6))     # cycles, about 2 GHz
        s.record()
        fn()
        e.record()
        events.append((s, e))
        if lead_ms > 0:
            torch.cuda.synchronize(device)
    torch.cuda.synchronize(device)
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def device_busy_ms(fn, device: torch.device, calls: int):
    """(device ms per call, device events per call) of fn on the card, from
    torch.profiler's trace of ``calls`` calls after a warm-up call: every
    kernel and copy the calls ran on the card, gaps left out. Unlike
    ``median_ms`` with ``lead_ms``, this holds for a function that waits
    for the card inside (a pageable host-to-device copy does)."""
    fn()
    torch.cuda.synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(device)
    # a user annotation spans the kernels it launched on the device timeline
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    return sum(e.device_time_total for e in events) / 1e3 / calls, len(events) / calls


def device_label(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

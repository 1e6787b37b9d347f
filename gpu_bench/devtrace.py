"""A traced window under ``torch.profiler`` and what the readers take from
it: the device's busy time, its launches, each kernel's device time, and
the breakdown (the device operations that took most time, the longest
idle gaps by the host span they fell in)."""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW_SPAN = "bench.window"
# span prefixes of the port and of this benchmark: their device-side
# copies are not operations
SPAN_PREFIXES = ("bench.", "compact.", "mxu.", "dense.", "scan.", "mfe.",
                 "ProfilerStep")
COPIES = ("Memcpy", "Memset")
TOP = 10


@dataclass
class DeviceTrace:
    window_s: float                     # host clock of the traced window
    busy_s: float                       # union of device operations
    launches: int                       # kernels (copies and fills apart)
    by_name: dict[str, tuple[int, float]]   # operation -> (count, s)
    idle_by_span: dict[str, float]      # idle seconds by host span

    def kernel_time(self, fragment: str) -> tuple[int, float]:
        """(launches, device seconds) of kernels whose name holds
        ``fragment``."""
        count = secs = 0
        for name, (c, s) in self.by_name.items():
            if fragment in name:
                count += c
                secs += s
        return count, secs

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:96], s] for n, (_, s) in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _is_span(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or \
        e.name.startswith(SPAN_PREFIXES)


def traced(fn, device: torch.device) -> DeviceTrace:
    """Run ``fn`` once under the profiler, between two synchronises."""
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            t = time.perf_counter()
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t
    return summarize(prof.events(), window_s)


def summarize(events, window_s: float) -> DeviceTrace:
    host_spans, ops = [], []
    w0 = w1 = None
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if _is_device(e):
            if not _is_span(e):
                ops.append((start, end, e.name))
        elif _is_span(e):
            if e.name == WINDOW_SPAN:
                w0, w1 = start, end
            else:
                host_spans.append((start, end, e.name))
    ops.sort()
    by_name: dict[str, tuple[int, float]] = {}
    launches = 0
    for start, end, name in ops:
        c, s = by_name.get(name, (0, 0.0))
        by_name[name] = (c + 1, s + (end - start) * 1e-6)
        launches += not name.startswith(COPIES)
    # the union of the operations' intervals, and the gaps between them
    busy_us, gaps = 0.0, []
    cur_s = cur_e = None
    for start, end, _ in ops:
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
                gaps.append((cur_e, start))
            elif w0 is not None and start > w0:
                gaps.append((w0, start))
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        busy_us += cur_e - cur_s
        if w1 is not None and w1 > cur_e:
            gaps.append((cur_e, w1))
    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        inside = [(e - s, n) for s, e, n in host_spans if s <= mid <= e]
        name = min(inside)[1] if inside else "(no span)"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) * 1e-6
    return DeviceTrace(window_s, busy_us * 1e-6, launches, by_name, idle)

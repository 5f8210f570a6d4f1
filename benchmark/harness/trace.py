"""The device trace of a traced run: `torch.profiler` (CUDA activity) over
the measured window, reduced to kernel intervals on the host's
perf_counter clock.

The profiler's clock is tied to the host's by one calibration kernel
(`torch.cuda._sleep`, a spin kernel) launched right after a synchronise at
the window's start: its start in the trace is taken as that host instant.
The busy time is the union of the kernel, copy and set intervals; the idle
gaps between them are named by the innermost benchmark span that holds
their middle.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

MARK = "spin_kernel"


class Trace:
    def __init__(self):
        self.prof = None
        self.events = []          # (name, start_s, end_s), host clock
        self.t0 = self.t1 = None

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def stop(self):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        raw = list(_kineto_events(self.prof))
        marks = [s for n, s, _ in raw if MARK in n]
        if not marks:
            raise RuntimeError("the calibration kernel is missing from the trace")
        off = self.t0 - min(marks)
        self.events = sorted(((_short(n), s + off, e + off) for n, s, e in raw if MARK not in n),
                             key=lambda ev: ev[1])
        self.prof = None

    @property
    def window_s(self):
        return self.t1 - self.t0

    def busy(self):
        """Merged device-busy intervals inside the window."""
        out = []
        for _, s, e in self.events:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self):
        return sum(e - s for s, e in self.busy())

    def kernel_seconds(self, names):
        """Total seconds of the events of the kernels `names` (short names)."""
        return sum(e - s for n, s, e in self.events if n in names)

    def breakdown(self, spans, top=10):
        """The device operations that took most time, and the idle time by
        the innermost span (the video's own span, else "between") that holds
        each gap's middle."""
        by_op = defaultdict(float)
        for n, s, e in self.events:
            by_op[n] += e - s
        levels = [sorted((sp for sp in spans if sp[0] != "video"), key=lambda sp: sp[1]),
                  sorted((sp for sp in spans if sp[0] == "video"), key=lambda sp: sp[1])]
        starts = [[sp[1] for sp in lv] for lv in levels]

        def label(t):
            for lv, st in zip(levels, starts):
                i = bisect.bisect_right(st, t) - 1
                if i >= 0 and lv[i][2] >= t:
                    return lv[i][0]
            return "between"

        gaps = defaultdict(float)
        last = self.t0
        for s, e in self.busy() + [[self.t1, self.t1]]:
            if s > last:
                gaps[label(0.5 * (s + last))] += s - last
            last = max(last, e)
        pick = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": pick(by_op), "idle_gaps": pick(gaps)}


def _short(name: str) -> str:
    """A kernel's name without its parameter list, template arguments,
    return type and namespaces: "void a3r::fa::f<64>(int)" -> "f"."""
    s = name
    if s.endswith(")"):
        depth = 0
        for i in range(len(s) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(s[i], 0)
            if depth == 0:
                s = s[:i]
                break
    depth, out = 0, []
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    s = "".join(out).strip().split(" ")[-1].split("::")[-1]
    return (s or name)[:120]


def _kineto_events(prof):
    """(name, start_s, end_s) of every device event, on the profiler's clock."""
    dev = torch.autograd.DeviceType.CUDA
    res = getattr(prof.profiler, "kineto_results", None)
    if res is None:        # older profilers: the parsed events
        for e in prof.events():
            if e.device_type == dev:
                yield e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6
        return
    for e in res.events():
        if e.device_type() != dev:
            continue
        if hasattr(e, "start_ns"):
            s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        else:
            s, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
        yield e.name(), s, s + d

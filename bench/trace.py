"""The profiler's trace, read back from its chrome-trace file.

``torch.profiler`` writes host events (operators, ``record_function``
ranges, CUDA runtime and driver calls) and device events (kernels, copies,
sets) with times in microseconds on one clock; a kernel and the host call
that launched it share a ``correlation`` id.  :func:`load` keeps what the
metric readers need; the helpers below answer their questions."""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field

#: device events that are work on the card
DEVICE_CATS = {"kernel": "kernels", "gpu_memcpy": "copies",
               "gpu_memset": "copies"}
#: host events that launch device work
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: host events that say what the host was doing
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    kernels: list = field(default_factory=list)   # (start, end, name, corr)
    copies: list = field(default_factory=list)    # (start, end, name)
    launches: dict = field(default_factory=dict)  # corr -> host start
    host: list = field(default_factory=list)      # (start, end, name, tid)

    def ranges(self, prefix: str) -> list:
        """Host ranges (``record_function``) whose name starts with
        ``prefix``, in time order: (start, end, name, tid)."""
        return sorted(h for h in self.host if h[2].startswith(prefix))

    def window(self, name: str):
        """(start, end, count) spanned by the ranges called ``name``."""
        rs = [h for h in self.host if h[2] == name]
        if not rs:
            return None
        return min(r[0] for r in rs), max(r[1] for r in rs), len(rs)

    def launched_in(self, ranges) -> list[list]:
        """For each host range, the kernels whose launch lies inside it."""
        starts = [r[0] for r in ranges]
        out = [[] for _ in ranges]
        for k in self.kernels:
            t = self.launches.get(k[3])
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ranges[i][1]:
                out[i].append(k)
        return out


def load(path) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    tr = Trace()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        start = float(e["ts"])
        end = start + float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            if cat == "kernel":
                tr.kernels.append((start, end, e["name"],
                                   args.get("correlation")))
            else:
                tr.copies.append((start, end, e["name"]))
        elif cat in HOST_CATS:
            tr.host.append((start, end, e["name"], e.get("tid")))
            if cat in LAUNCH_CATS and "correlation" in args:
                tr.launches[args["correlation"]] = start
    tr.kernels.sort()
    tr.copies.sort()
    tr.host.sort()
    return tr


def union(intervals, lo: float, hi: float) -> list:
    """The union of (start, end, ...) intervals clipped to [lo, hi], as
    disjoint (start, end) pairs in order."""
    out = []
    for iv in sorted(intervals):
        a, b = max(iv[0], lo), min(iv[1], hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_us(tr: Trace, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] in which a kernel or a copy ran."""
    return sum(b - a for a, b in union(tr.kernels + tr.copies, lo, hi))


def idle_gaps(tr: Trace, lo: float, hi: float) -> list:
    """The (start, end) intervals of [lo, hi] with nothing on the card."""
    gaps, at = [], lo
    for a, b in union(tr.kernels + tr.copies, lo, hi):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def host_labels(tr: Trace, times, tid) -> list[str]:
    """For each time (ascending), the innermost host event of thread
    ``tid`` running then: a sweep over the thread's nested events."""
    events = [h for h in tr.host if h[3] == tid]
    out, stack, i = [], [], 0
    for t in times:
        while i < len(events) and events[i][0] <= t:
            while stack and stack[-1][1] < events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "host: outside any operation")
    return out


def breakdown(tr: Trace, lo: float, hi: float, tid, top: int = 10) -> dict:
    """The device operations that took most time in [lo, hi], and the idle
    time there by what the host was doing when it began; seconds."""
    by_op: dict[str, float] = {}
    for k in tr.kernels + tr.copies:
        a, b = max(k[0], lo), min(k[1], hi)
        if b > a:
            by_op[k[2]] = by_op.get(k[2], 0.0) + (b - a) / 1e6
    by_host: dict[str, float] = {}
    gaps = idle_gaps(tr, lo, hi)
    for (a, b), name in zip(gaps, host_labels(tr, [g[0] for g in gaps],
                                              tid)):
        by_host[name] = by_host.get(name, 0.0) + (b - a) / 1e6
    return {"device_ops": [[n, s] for n, s in sorted(
                by_op.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(
                by_host.items(), key=lambda kv: -kv[1])[:top]]}

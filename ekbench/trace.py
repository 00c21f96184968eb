"""The traced run: `torch.profiler` over the window, its Chrome trace read
back into device intervals, and what the per-layer readers see (`Trace`).

A kernel is attributed to the harness span (`chunk`, `series`, ...) in
which the host launched it: the kernel's correlation id leads to its
launch call on the host, whose time falls inside the span.  Device busy
time is the union of every kernel, copy and fill interval on the card.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile

_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the harness's own spans inside the window (never nested in each other);
# other annotations, such as torch.distributed's around each message, are not
# the harness's and nest inside them
SPANS = ("chunk", "series", "window.drain")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profiler():
    """A started profiler of the host and the card."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def events(prof) -> list:
    """Stop `prof` and return its trace's events (the file goes to TMPDIR
    and is deleted)."""
    prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(intervals):
    """Total length of a union of (start, end) intervals, and its gaps."""
    total, gaps, end = 0.0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total, gaps


def short(name: str) -> str:
    """A kernel's name without its namespace, template arguments and
    signature."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    m = re.match(r"[\w:~]+", name)
    return (m.group(0) if m else name)[:64] or "?"


class Trace:
    """The traced window as the per-layer readers see it.

    kernels: [(name, start_us, dur_us, span, span_start)] of every kernel,
    span the harness span that launched it and span_start the host time
    that span began (None where the launch is unknown);
    window: (start_us, end_us) of the harness's `window` span; busy_us:
    device busy time inside it; gaps: its idle gaps (start_us, end_us)."""

    def __init__(self, evs: list):
        spans = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                       for e in evs if e.get("cat") == "user_annotation"
                       and e.get("ph") == "X")
        win = [s for s in spans if s[2] == "window"]
        self.window = (win[0][0], win[0][1]) if win else (
            min((s[0] for s in spans), default=0.0),
            max((s[1] for s in spans), default=0.0))
        self._spans = [s for s in spans if s[2] in SPANS]
        self._starts = [s[0] for s in self._spans]
        launch = {}
        for e in evs:
            if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {}):
                launch[e["args"]["correlation"]] = e["ts"]
        w0, w1 = self.window
        self.kernels = []
        device = []
        for e in evs:
            if e.get("cat") not in _DEVICE_CATS or e.get("ph") != "X":
                continue
            s, d = float(e["ts"]), float(e.get("dur", 0.0))
            if s + d < w0 or s > w1:
                continue
            device.append((max(s, w0), min(s + d, w1)))
            if e["cat"] == "kernel":
                host = launch.get(e.get("args", {}).get("correlation"))
                sp = (None, None) if host is None else self._span_at(host)
                self.kernels.append((e["name"], s, d, *sp))
        self.busy_us, self.gaps = _union(device)

    def _span_at(self, t: float):
        """(name, start) of the harness span the host was in at trace time
        t, or (None, None)."""
        i = bisect.bisect_right(self._starts, t)
        if i:
            s, e, name = self._spans[i - 1]
            if t <= e:
                return name, s
        return None, None

    def instances(self, span: str):
        """(first kernel start, last kernel end) of each `span` instance
        that launched kernels."""
        ext = {}
        for _, s, d, name, start in self.kernels:
            if name == span:
                lo, hi = ext.get(start, (s, s + d))
                ext[start] = (min(lo, s), max(hi, s + d))
        return list(ext.values())

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def matching(self, pattern: str, span=None):
        """Kernels whose name matches the regex `pattern` (and were
        launched in `span`, where given)."""
        rx = re.compile(pattern)
        return [k for k in self.kernels if rx.search(k[0])
                and (span is None or k[3] == span)]

    def busy_in(self, span: str, exclude: str = None) -> float:
        """Device-busy microseconds of the kernels launched in `span`
        (less those matching `exclude`), as a union."""
        rx = re.compile(exclude) if exclude else None
        ks = [(s, s + d) for n, s, d, sp, _ in self.kernels
              if sp == span and not (rx and rx.search(n))]
        return _union(ks)[0]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps by the harness span the host was in when each began."""
        by = {}
        for n, _, d, _, _ in self.kernels:
            by[short(n)] = by.get(short(n), 0.0) + d
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(((self._span_at(s)[0] or "outside any span", e - s)
                       for s, e in self.gaps), key=lambda g: -g[1])[:top]
        return {"device_ops": [[n, d * 1e-6] for n, d in ops],
                "idle_gaps": [[n, d * 1e-6] for n, d in gaps]}

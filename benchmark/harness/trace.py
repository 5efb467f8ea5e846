"""What a torch.profiler window says about the device: its busy time,
device time by kernel name, and the idle gaps labelled by what the host
was doing."""

from __future__ import annotations

import bisect
import dataclasses


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    kernels: dict            # name -> (seconds, launches)
    ops: list                # [(name, seconds)] by total time, descending
    gaps: list               # [(label, seconds)] longest first

    def family_s(self, *parts: str) -> tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds any of parts."""
        s, k = 0.0, 0
        for name, (sec, n) in self.kernels.items():
            if any(p in name for p in parts):
                s, k = s + sec, k + n
        return s, k


def _short(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    head = name.split("(")[0].split("<")[0]
    return head.replace("void ", "").strip() or name[:60]


def read(prof, window_s: float) -> DeviceTrace:
    """The device events of a finished torch.profiler.profile."""
    events = prof.profiler.kineto_results.events()
    dev, host = [], []
    for e in events:
        t0, dur = e.start_ns() / 1e9, e.duration_ns() / 1e9
        if e.device_type().name == "CUDA":
            dev.append((t0, t0 + dur, e.name()))
        else:
            host.append((t0, t0 + dur, e.name()))
    dev.sort()
    kernels: dict = {}
    for a, b, name in dev:
        s, n = kernels.get(name, (0.0, 0))
        kernels[name] = (s + (b - a), n + 1)
    busy, gaps = 0.0, []
    cur_a = cur_b = None
    for a, b, _ in dev:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
                gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    host.sort()
    starts = [h[0] for h in host]
    labelled: dict = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:50]:
        mid = 0.5 * (a + b)
        # the innermost host event open at the gap's middle, among the
        # last few thousand to start before it
        i = bisect.bisect_right(starts, mid)
        inside = [h for h in host[max(0, i - 4000):i] if h[1] >= mid]
        label = min(inside, key=lambda h: h[1] - h[0])[2] if inside else "host: no traced op"
        labelled.setdefault(label, []).append(b - a)
    gap_list = sorted(((k, max(v)) for k, v in labelled.items()), key=lambda kv: -kv[1])
    by_op: dict = {}
    for name, (s, _) in kernels.items():
        by_op[_short(name)] = by_op.get(_short(name), 0.0) + s
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])
    return DeviceTrace(window_s, busy, kernels, ops, gap_list)

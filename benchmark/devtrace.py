"""The reduction from a torch.profiler window to the per-layer
metrics: device records, host records, the union of device busy
intervals, and the breakdown of device time and of idle gaps.

A frozen copy of what dsptpu_torch/utils/profiling.py does for its
`device_by_kernel`, so that a change to the program cannot change the
yardstick: the window opens after a spin of about 1 ms that is left out
(the device records of a profile's first fraction of a millisecond have
gone missing on the H100), records of user annotations are not device
work, and a window with no device record is reported as such, never as
a time of 0.
"""

import bisect
import dataclasses
import re

# the benchmark's own ranges in the profiled window
WINDOW = "benchmark.window"
CALL = "benchmark.call"


@dataclasses.dataclass
class Record:
    """One interval of a trace, in seconds on the profiler's clock.
    kind: "kernel", "memcpy" or "memset" on the device, "host" on the
    CPU."""
    name: str
    start: float
    end: float
    kind: str


@dataclasses.dataclass
class Trace:
    """What the per-layer readers read.

    calls: closed-loop calls in the profiled window; window: (start,
    end) of that window; device, host: its records; host_s: the time
    each call of the measured window took to return, before its
    synchronize, with no profiler attached; bound_s: the least time one
    call could take on the card (roofline.bound_s), or None."""
    calls: int
    window: tuple
    device: list
    host: list
    host_s: list
    bound_s: float = None

    def in_window(self, kinds=("kernel", "memcpy", "memset")):
        """Device records of `kinds` that overlap the window, clipped."""
        t0, t1 = self.window
        return [Record(r.name, max(r.start, t0), min(r.end, t1), r.kind)
                for r in self.device
                if r.kind in kinds and r.end > t0 and r.start < t1]

    def busy_intervals(self):
        return union(self.in_window())

    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals())

    def window_s(self):
        return self.window[1] - self.window[0]


def union(records):
    """Sorted, disjoint [(start, end)] covering the records."""
    out = []
    for r in sorted(records, key=lambda r: r.start):
        if out and r.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], r.end)
        else:
            out.append([r.start, r.end])
    return [tuple(iv) for iv in out]


def device_kind(name):
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def short_name(name):
    """A kernel's name without its argument list and anonymous
    namespaces: 'void (anonymous namespace)::f<T>(int)' -> 'f<T>'."""
    name = name.replace("(anonymous namespace)::", "")
    m = re.search(r"([\w:]+(?:<[^()]*>)?)\(", name)
    return m.group(1) if m else name[:80]


def records(prof):
    """(device records, host records, window) of a torch.profiler
    profile; the window is the record_function(WINDOW) range, or None
    where the profile has none (a profile of the device alone). The
    leading spin's records are left out."""
    from torch.autograd import DeviceType
    dev, host, window = [], [], None
    for e in prof.events():
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation and "spin" not in e.name:
                dev.append(Record(e.name, start, end, device_kind(e.name)))
        elif e.device_type == DeviceType.CPU:
            if e.name == WINDOW:
                window = (start, end)
            else:
                host.append(Record(e.name, start, end, "host"))
    return dev, host, window


def _host_label(host_sorted, starts, t):
    """What the host was doing at time t: the innermost host record that
    covers t, or else the last one that ended before it (the benchmark's
    own per-call ranges left out)."""
    i = bisect.bisect_right(starts, t)
    best, last = None, None
    for r in reversed(host_sorted[max(0, i - 400): i]):
        if r.name == CALL:
            continue
        if r.end >= t:
            if best is None or r.end - r.start < best.end - best.start:
                best = r
        elif last is None or r.end > last.end:
            last = r
    if best is not None:
        return best.name
    return f"python after {last.name}" if last is not None else "python"


def _ranked(d, top):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
            ][:top]


def device_ops(trace, top=10):
    """[[name, seconds], ...]: the device operations with the most time
    in the window, summed by name, largest first."""
    ops = {}
    for r in trace.in_window():
        key = short_name(r.name)
        ops[key] = ops.get(key, 0.0) + (r.end - r.start)
    return _ranked(ops, top)


def idle_gaps(trace, top=10):
    """[[what the host was doing, seconds], ...]: the idle time between
    the device's busy intervals in the window, summed by the host's
    activity at each gap's middle, largest first."""
    busy = trace.busy_intervals()
    t0, t1 = trace.window
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    host_sorted = sorted(trace.host, key=lambda r: r.start)
    starts = [r.start for r in host_sorted]
    gaps = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            key = _host_label(host_sorted, starts, (a + b) / 2)
            gaps[key] = gaps.get(key, 0.0) + (b - a)
    return _ranked(gaps, top)

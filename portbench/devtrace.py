"""What a profiled window of steps says: device operations with their times,
the host operations beside them, the device's busy union, its idle gaps and
the kernels attributed to the operations of ``portbench/kernels/<op>.py``.

Read from ``torch.profiler``'s own events (kineto's, host and device on one
clock), so nothing is written to disk.  A kernel belongs to the operation
whose file lists the longest of its name patterns found in the kernel's name
(``ssd::ssd_chunk_bwd`` before ``ssd::ssd_chunk``); a kernel no pattern
matches belongs to no operation.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict


def _events(prof):
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        start = e.start_ns()
        row = (e.name(), start, start + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            dev.append(row)
        elif e.device_type() == DeviceType.CPU:
            host.append(row)
    return dev, host


def owner(name: str, ops: dict) -> str | None:
    """The operation whose longest matching pattern is the longest."""
    best, length = None, 0
    for op, mod in ops.items():
        for pat in mod.PATTERNS:
            if pat in name and len(pat) > length:
                best, length = op, len(pat)
    return best


@dataclasses.dataclass
class Trace:
    device: list          # (name, start_ns, end_ns) of every device operation
    host: list            # (name, start_ns, end_ns) of every host operation
    steps: int            # steps the profiler wrapped
    wall_s: float         # their wall time by the host clock

    @classmethod
    def of(cls, prof, steps: int, wall_s: float) -> Trace:
        return cls(*_events(prof), steps, wall_s)

    def merged(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals."""
        out: list[list[int]] = []
        for _, s, e in sorted(self.device, key=lambda r: r[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e9

    def span_s(self) -> float:
        """From the first device operation's start to the last one's end."""
        m = self.merged()
        return (m[-1][1] - m[0][0]) / 1e9 if m else 0.0

    def idle_pct(self) -> float | None:
        span = self.span_s()
        return 100.0 * (1.0 - self.busy_s() / span) if span > 0 else None

    def ms_per_step(self, keep) -> float:
        """Device ms a step of the operations whose name ``keep`` accepts."""
        return sum(e - s for n, s, e in self.device if keep(n)) / 1e6 / self.steps

    def by_op(self, ops: dict) -> dict[str, float]:
        """Device ms a step of each operation that ran (ops: name → module)."""
        out: dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            op = owner(n, ops)
            if op is not None:
                out[op] += (e - s) / 1e6 / self.steps
        return dict(out)

    def top_ops(self, k: int = 10) -> list:
        total: dict[str, int] = defaultdict(int)
        for n, s, e in self.device:
            total[n] += e - s
        return [[n, t / 1e9] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:k]]

    def host_at(self, t: int) -> str:
        """The innermost host operation running at ``t``."""
        best = None
        for n, s, e in self.host:
            if s <= t < e and (best is None or s > best[1]):
                best = (n, s)
        return best[0] if best else "(no host operation)"

    def idle_gaps(self, k: int = 10) -> list:
        m = self.merged()
        gaps = sorted(((m[i + 1][0] - m[i][1], m[i][1]) for i in range(len(m) - 1)),
                      reverse=True)[:k]
        return [[self.host_at(t), g / 1e9] for g, t in gaps]

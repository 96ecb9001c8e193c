"""The device's side of a traced run, from ``torch.profiler``.

The method is ``chip_smoke.py``'s, copied: a session opens with a long
marker spin that is waited for and a lead-in of markers (a session's first
device events can be missing from its profile), the harness queues the
marker kernel (``torch.cuda._sleep``) after each unit of work it names (a
prefill, a decode step, a train step), and the device's events are split
into those units at the markers, in the order the device ran them, never
by the host's clock.  Only the device's activity is recorded, and it is
read from the profiler's raw events, so a window of some hundred thousand
kernels is reduced in seconds.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import torch

__all__ = ["Tracer", "Part", "DeviceTrace"]

MARK_CYCLES = 1000
LEAD_IN = 2
LEAD_IN_CYCLES = 2_000_000
NAME_CHARS = 100                  # of a kernel's name in the breakdown


@dataclass
class Part:
    """The device events of one unit of work, each (name, start_ns,
    end_ns), in the device's order."""

    label: str
    events: list = field(default_factory=list)
    info: dict = field(default_factory=dict)   # the unit's shapes

    @property
    def busy_s(self) -> float:
        return sum(e - s for _, s, e in self.events) / 1e9

    @property
    def span_s(self) -> float:
        """From its first event's start to its last event's end."""
        if not self.events:
            return 0.0
        return (self.events[-1][2] - self.events[0][1]) / 1e9


@dataclass
class DeviceTrace:
    """A traced window: its parts, labelled as the harness named them, the
    window's length on the host's clock, and what fell outside the parts."""

    parts: list
    window_s: float
    stray: int = 0            # device events outside every part

    def events(self):
        for part in self.parts:
            yield from part.events

    @property
    def busy_s(self) -> float:
        """The union of the device's event intervals, in seconds."""
        spans = sorted((s, e) for _, s, e in self.events())
        total, end = 0, None
        for s, e in spans:
            if end is None or s >= end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e9

    def top_ops(self, n: int = 10) -> list:
        """The device operations that took most time: [name, seconds],
        each name cut to its first ``NAME_CHARS`` characters."""
        acc = defaultdict(int)
        for name, s, e in self.events():
            acc[name[:NAME_CHARS]] += e - s
        top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle time by what the host was doing: within a unit of work
        (``<label>: between ops``), before its first op (``<label>:
        before its first op``), or in a unit that ran nothing on the device
        (such as waiting for arrivals: ``<label>``), summed over the
        window."""
        acc = defaultdict(int)
        last_end, waiting = None, None
        for part in self.parts:
            if not part.events:
                waiting = part.label
            for i, (_, s, e) in enumerate(part.events):
                if last_end is not None and s > last_end:
                    where = (f"{part.label}: between ops" if i else
                             waiting or f"{part.label}: before its first op")
                    acc[where] += s - last_end
                last_end = e if last_end is None else max(last_end, e)
                waiting = None
        top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]


class Tracer:
    """Queues markers and labels for a window run under the profiler.

    ``mark(label)`` closes the unit of work ``label`` (queued on the
    device after its last kernel).  Off (``enabled`` false) it does
    nothing, so an untraced run queues no marker."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.labels: list[tuple[str, dict]] = []
        self._prof = None
        self._marker = None
        self._trace = None
        self._stopped = False

    def mark(self, label: str, **info) -> None:
        if self.enabled:
            torch.cuda._sleep(MARK_CYCLES)
            self.labels.append((label, info))

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        self._marker = self._marker_name()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda._sleep(LEAD_IN_CYCLES)
        torch.cuda.synchronize()
        for _ in range(LEAD_IN):
            torch.cuda._sleep(MARK_CYCLES)
        self.labels = []

    def stop(self, window_s: float) -> DeviceTrace | None:
        """Close the session -> the window's parts, one a label; None when
        the session does not hold them whole.  Once stopped, marks do
        nothing and a second call returns the first call's result."""
        if self._stopped or not self.enabled:
            return self._trace
        self._stopped = True
        self.enabled = False
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        events = self._device_events(self._prof)
        self._trace = split(events, self._marker, self.labels, window_s)
        return self._trace

    @staticmethod
    def _device_events(prof) -> list:
        out = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA \
                    and not e.is_user_annotation():
                s = e.start_ns()
                out.append((e.name(), s, s + e.duration_ns()))
        out.sort(key=lambda ev: ev[1])
        return out

    def _marker_name(self) -> str:
        from torch.profiler import ProfilerActivity, profile

        for _ in range(5):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(LEAD_IN):
                    torch.cuda._sleep(MARK_CYCLES)
                torch.cuda.synchronize()
            names = {name for name, _, _ in self._device_events(prof)}
            if len(names) == 1:
                return names.pop()
        raise RuntimeError("no profiler session showed the marker kernel "
                           "alone")


def split(events: list, marker: str, labels: list, window_s: float
          ) -> DeviceTrace | None:
    """Device events -> the labelled parts between markers.  The session
    opens with ``LEAD_IN`` markers (one may be missing), then one marker
    closes each labelled part and a last one closes the window."""
    chunks = [[]]
    for ev in events:
        if ev[0] == marker:
            chunks.append([])
        else:
            chunks[-1].append(ev)
    # the last chunk lies after the closing marker; the one before it is
    # what ran between the last labelled part and the close
    n = len(labels)
    if len(chunks) < n + 2:
        return None
    body = chunks[-n - 2:-2]
    stray = sum(len(c) for c in chunks[:-n - 2]) + len(chunks[-2]) \
        + len(chunks[-1])
    parts = [Part(label, chunk, info)
             for (label, info), chunk in zip(labels, body)]
    return DeviceTrace(parts=parts, window_s=window_s, stray=stray)

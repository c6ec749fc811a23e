"""Event-time window assignment — tumbling and sliding.

Windows are half-open event-time intervals ``[start, end)`` indexed by an
integer so the tracker can address them without materializing interval
objects per event.  Assignment is pure arithmetic on the event timestamp;
an event exactly on a boundary belongs to the window *starting* there
(the half-open convention every stream processor shares).
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Window:
    """Half-open event-time interval [start, end)."""

    start: float
    end: float

    def __contains__(self, ts: float) -> bool:
        return self.start <= ts < self.end

    @property
    def size(self) -> float:
        return self.end - self.start


class WindowAssigner:
    """Maps event timestamps to integer window indices and back."""

    def assign(self, ts: float) -> list[int]:
        raise NotImplementedError

    def window(self, index: int) -> Window:
        raise NotImplementedError

    def max_windows_per_event(self) -> int:
        raise NotImplementedError

    def min_live_index(self, watermark: float) -> int:
        """Smallest window index the watermark has not yet closed — the
        device fan-out's late-masking bound (``engine.stages.window_fanout``
        drops copies below it).

        Seeds a float64 guess, then corrects with the *same*
        ``window(i).end <= watermark`` predicate ``WindowTracker.is_late``
        uses, so host admission and device masking agree exactly even when
        the watermark sits on a window boundary.
        """
        if watermark == float("-inf"):
            return -(2 ** 31)
        if watermark == float("inf"):
            return 2 ** 31 - 1
        w0 = self.window(0)
        step = self.window(1).start - w0.start
        cand = math.floor((watermark - w0.size - w0.start) / step) + 1
        while self.window(cand).end <= watermark:
            cand += 1
        while self.window(cand - 1).end > watermark:
            cand -= 1
        return cand


@dataclass(frozen=True)
class TumblingWindows(WindowAssigner):
    """Non-overlapping fixed-size windows: index i covers
    [offset + i*size, offset + (i+1)*size)."""

    size: float
    offset: float = 0.0

    def __post_init__(self) -> None:
        if self.size <= 0:
            raise ValueError("window size must be positive")

    def assign(self, ts: float) -> list[int]:
        return [math.floor((ts - self.offset) / self.size)]

    def window(self, index: int) -> Window:
        start = self.offset + index * self.size
        return Window(start, start + self.size)

    def max_windows_per_event(self) -> int:
        return 1


@dataclass(frozen=True)
class SlidingWindows(WindowAssigner):
    """Overlapping windows of ``size`` starting every ``slide``: index i
    covers [offset + i*slide, offset + i*slide + size).  An event belongs to
    every window whose interval contains it — up to ceil(size / slide)."""

    size: float
    slide: float
    offset: float = 0.0

    def __post_init__(self) -> None:
        if self.size <= 0 or self.slide <= 0:
            raise ValueError("size and slide must be positive")
        if self.slide > self.size:
            raise ValueError("slide > size leaves event-time gaps")

    def assign(self, ts: float) -> list[int]:
        rel = ts - self.offset
        last = math.floor(rel / self.slide)
        first = math.floor((rel - self.size) / self.slide) + 1
        return list(range(first, last + 1))

    def window(self, index: int) -> Window:
        start = self.offset + index * self.slide
        return Window(start, start + self.size)

    def max_windows_per_event(self) -> int:
        return math.ceil(self.size / self.slide)

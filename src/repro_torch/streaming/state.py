"""Watermark bookkeeping and the in-flight window ring.

The device engine carries per-window partial aggregates in a bounded ring of
``n_slots`` carry slots (``engine.plan``'s streaming carries).  This module
owns the host-side view of that ring: which window index lives in which slot,
where the watermark stands, which windows are ripe for finalization, and
which events are too late to admit.

Slot addressing is *modular*: window ``w`` always lives in slot
``w % n_slots``.  The on-device fan-out stage computes the same expression
(``engine.stages.window_fanout``), so no slot table ever crosses the
host→device boundary — the tracker only validates that the slot is free and
remembers the assignment for finalization.

Watermark = max event time observed − allowed lateness.  A window finalizes
once the watermark reaches its end; finalization happens in window-start
order so downstream consumers see an ordered stream of closed windows.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from .windows import WindowAssigner


class LateEventError(Exception):
    """An event arrived for a window that already finalized."""


@dataclass
class WindowTracker:
    """Tracks in-flight windows, their ring slots, and the watermark."""

    assigner: WindowAssigner
    n_slots: int
    allowed_lateness: float = 0.0
    watermark: float = float("-inf")
    active: dict[int, int] = field(default_factory=dict)   # window idx → slot
    finalized: int = 0
    late_dropped: int = 0
    _slots: dict[int, int] = field(default_factory=dict)   # slot → window idx
    # wall-clock instant the watermark passed each active window's end —
    # the "close" end of the close-to-emit latency histogram.  Transient
    # (not checkpointed): latency is a property of one run's scheduling,
    # and a restored run re-times replayed windows from its own clock.
    closed_at: dict[int, float] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.n_slots < 1:
            raise ValueError("need at least one window slot")
        # fail at construction when the ring cannot hold the window span —
        # the same bound pipeline.lower enforces at build and planlint's
        # PL001 reports, so a hand-built tracker gets the pointed error
        # here instead of a mid-stream "window ring full"
        size = getattr(self.assigner, "size", None)
        if size is not None:
            from ..analysis.planlint import min_slots_required
            need = min_slots_required(size, getattr(self.assigner, "slide",
                                                    None),
                                      self.allowed_lateness)
            if self.n_slots < need:
                raise ValueError(
                    f"n_slots={self.n_slots} cannot hold the window span; "
                    f"need >= {need} for size={size}, "
                    f"slide={getattr(self.assigner, 'slide', None) or size},"
                    f" lateness={self.allowed_lateness}")
        self._slots = {s: w for w, s in self.active.items()}

    # -- admission -----------------------------------------------------------
    def is_late(self, window_index: int) -> bool:
        """True when the window already closed (watermark passed its end)."""
        return self.assigner.window(window_index).end <= self.watermark

    def min_admissible(self) -> int:
        """Smallest non-late window index at the current watermark — shipped
        to the device fan-out stage as its late-masking bound."""
        return self.assigner.min_live_index(self.watermark)

    def slot_for(self, window_index: int) -> int | None:
        """Ring slot carrying this window (``window_index % n_slots``),
        claiming it on first sight.

        Returns ``None`` for a late window (the event must be dropped — its
        aggregate was already emitted); the caller accounts the drop via
        ``note_late``, never this method — see the ownership note there.
        Raises ``LateEventError`` if the window's modular slot still
        carries an older active window, which means ``n_slots`` is too
        small for the configured window span + lateness: admitting the
        event would corrupt that window's carry slice.
        """
        if window_index in self.active:
            return self.active[window_index]
        if self.is_late(window_index):
            return None
        slot = window_index % self.n_slots
        owner = self._slots.get(slot)
        if owner is not None:
            raise LateEventError(
                f"window ring full: slot {slot} of {self.n_slots} still "
                f"carries active window {owner} ({len(self.active)} active); "
                f"raise n_slots or reduce allowed_lateness / window overlap")
        self.active[window_index] = slot
        self._slots[slot] = window_index
        return slot

    def note_late(self, n: int) -> None:
        """Account ``n`` dropped (event, window) pairs.

        The **only** writer of ``late_dropped``: the coordinator calls it
        with the device fan-out's masked-pair count (device wire) or once
        per ``slot_for``-returned-``None`` pair it drops host-side (host
        wire).  Admission methods never count on their own — a pair that
        is skipped host-side but still rides the wire inside a record's
        window span is counted exactly once, by the device mask.
        """
        self.late_dropped += int(n)

    # -- watermark ------------------------------------------------------------
    def observe(self, max_event_time: float) -> float:
        """Advance the watermark (monotone) past a batch's max event time,
        stamping the close instant of every window it passes."""
        wm = max_event_time - self.allowed_lateness
        if wm > self.watermark:
            self.watermark = wm
            now = time.perf_counter()
            for w in self.active:
                if w not in self.closed_at \
                        and self.assigner.window(w).end <= wm:
                    self.closed_at[w] = now
        return self.watermark

    def ripe(self) -> list[tuple[int, int]]:
        """(window_index, slot) pairs whose end the watermark has passed,
        in window-start order — the finalization schedule."""
        done = [(w, s) for w, s in self.active.items()
                if self.assigner.window(w).end <= self.watermark]
        return sorted(done, key=lambda ws: self.assigner.window(ws[0]).start)

    def release(self, window_index: int) -> None:
        """Return a finalized window's slot to the ring."""
        slot = self.active.pop(window_index)
        del self._slots[slot]
        self.closed_at.pop(window_index, None)
        self.finalized += 1

    # -- checkpointing ---------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-serializable snapshot for the coordinator's checkpoint."""
        return {"watermark": self.watermark,
                "active": {str(w): s for w, s in self.active.items()},
                "free": [s for s in range(self.n_slots)
                         if s not in self._slots],
                "finalized": self.finalized,
                "late_dropped": self.late_dropped}

    def load_state_dict(self, d: dict) -> None:
        self.watermark = float(d["watermark"])
        self.active = {int(w): int(s) for w, s in d["active"].items()}
        self._slots = {s: w for w, s in self.active.items()}
        self.finalized = int(d["finalized"])
        self.late_dropped = int(d["late_dropped"])

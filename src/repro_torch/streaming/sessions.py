"""Session windows — gap-based, data-dependent event-time windows.

Fixed windows are pure arithmetic on the timestamp, so the host and device
can both compute them.  Session boundaries depend on the *observed* events
of each key: a session is a maximal run of events with no inactivity gap
longer than ``gap``, covering ``[first_event, last_event + gap)``.  That
makes assignment inherently host-side state — this module owns it, the way
``state.WindowTracker`` owns the fixed-window ring.

The carry story: a session holds exactly one key, so it does not need a
whole ring slot — it needs one *cell*, a (slot, bucket) pair of the same
scattered aggregate carry the fixed-window plans use.  Sessions of
different keys share slots freely (their buckets differ); two sessions of
the same key must sit in different slots.  When an out-of-order event
bridges two open sessions of one key, the tracker reports a cell *merge*
(src slot → dst slot, same bucket) that the coordinator applies on-device
(``CompiledStreamAggregate.merge_cell``) after folding any staged rows.

Under a hashed key space the tracker sees bucket ids, so keys that collide
into one bucket sessionize together — the same graceful degradation the
hashed aggregate path has.

A session finalizes once the watermark passes its end (last event + gap).
An event older than the watermark is admitted only if it lands inside a
still-open session; otherwise it is late — the session it would have
opened may already have been emitted.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .state import LateEventError


@dataclass
class Session:
    """One open session: ``[start, end)`` with ``end = last_event + gap``,
    carried in cell ``(slot, bucket)`` of the aggregate carry."""

    bucket: int
    start: float
    end: float
    slot: int


@dataclass
class SessionTracker:
    """Tracks open sessions per bucket, their carry cells, the watermark."""

    gap: float
    n_slots: int
    allowed_lateness: float = 0.0
    watermark: float = float("-inf")
    finalized: int = 0
    late_dropped: int = 0
    _open: dict[int, list[Session]] = field(default_factory=dict)
    _cells: set = field(default_factory=set)    # occupied (slot, bucket)

    def __post_init__(self) -> None:
        if self.gap <= 0:
            raise ValueError("session gap must be positive")
        if self.n_slots < 1:
            raise ValueError("need at least one session slot")

    # -- admission -----------------------------------------------------------
    def _overlapping(self, bucket: int, ts: float) -> list[Session]:
        """Open sessions of ``bucket`` the proto-window [ts, ts+gap)
        overlaps — the sessions this event extends or bridges.  Touching
        exactly (distance == gap) does not merge, matching the half-open
        window convention."""
        return [s for s in self._open.get(bucket, ())
                if s.start < ts + self.gap and ts < s.end]

    def admit(self, bucket: int, ts: float
              ) -> tuple[int, list[tuple[int, int]]] | None:
        """Admit one event: returns ``(slot, merges)`` or ``None`` for a
        late drop (the caller accounts it via ``note_late`` — admission
        never writes ``late_dropped`` itself, mirroring the fixed-window
        tracker's single-writer rule).  ``merges`` is a list of
        ``(src_slot, dst_slot)`` cell merges (same bucket) the caller must
        apply to the carry — after folding any rows already staged for the
        source slots — because the event bridged previously separate
        sessions.

        Raises ``LateEventError`` when a new session is needed but every
        slot's cell for this bucket is occupied (the ring is too small for
        the key's concurrent-session count); the caller may fold, advance
        the watermark, finalize, and retry — exactly the fixed-window
        mid-batch protocol.
        """
        hits = self._overlapping(bucket, ts)
        if not hits:
            if ts < self.watermark:
                return None
            sessions = self._open.setdefault(bucket, [])
            for slot in range(self.n_slots):
                if (slot, bucket) not in self._cells:
                    self._cells.add((slot, bucket))
                    sessions.append(Session(bucket, ts, ts + self.gap, slot))
                    return slot, []
            raise LateEventError(
                f"session ring full: all {self.n_slots} slots hold open "
                f"sessions for bucket {bucket}; raise n_slots or reduce "
                f"the session gap / allowed_lateness")
        hits.sort(key=lambda s: s.start)
        survivor = hits[0]
        survivor.start = min(survivor.start, ts)
        survivor.end = max(survivor.end, ts + self.gap)
        merges = []
        for other in hits[1:]:
            survivor.end = max(survivor.end, other.end)
            merges.append((other.slot, survivor.slot))
            self._cells.discard((other.slot, bucket))
            self._open[bucket].remove(other)
        return survivor.slot, merges

    # -- watermark ------------------------------------------------------------
    def observe(self, max_event_time: float) -> float:
        """Advance the watermark (monotone) past a batch's max event time."""
        wm = max_event_time - self.allowed_lateness
        if wm > self.watermark:
            self.watermark = wm
        return self.watermark

    def ripe(self) -> list[Session]:
        """Sessions whose end the watermark has passed, in (start, bucket)
        order — the finalization schedule."""
        done = [s for ss in self._open.values() for s in ss
                if s.end <= self.watermark]
        return sorted(done, key=lambda s: (s.start, s.bucket))

    def release(self, session: Session) -> None:
        """Return a finalized session's cell."""
        self._open[session.bucket].remove(session)
        if not self._open[session.bucket]:
            del self._open[session.bucket]
        self._cells.discard((session.slot, session.bucket))
        self.finalized += 1

    def note_late(self, n: int) -> None:
        """The only writer of ``late_dropped`` — see
        ``WindowTracker.note_late`` for the ownership rule."""
        self.late_dropped += int(n)

    @property
    def open_sessions(self) -> int:
        return sum(len(ss) for ss in self._open.values())

    # -- checkpointing ---------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-serializable snapshot for the coordinator's checkpoint."""
        return {"kind": "session",
                "watermark": self.watermark,
                "sessions": [[s.bucket, s.start, s.end, s.slot]
                             for ss in self._open.values() for s in ss],
                "finalized": self.finalized,
                "late_dropped": self.late_dropped}

    def load_state_dict(self, d: dict) -> None:
        self.watermark = float(d["watermark"])
        self.finalized = int(d["finalized"])
        self.late_dropped = int(d["late_dropped"])
        self._open = {}
        self._cells = set()
        for bucket, start, end, slot in d["sessions"]:
            s = Session(int(bucket), float(start), float(end), int(slot))
            self._open.setdefault(s.bucket, []).append(s)
            self._cells.add((s.slot, s.bucket))

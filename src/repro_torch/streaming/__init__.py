"""Streaming micro-batch engine — continuous MapReduce over event streams.

``StreamSource`` chunks a replayable event log into micro-batches;
``TumblingWindows`` / ``SlidingWindows`` assign event-time windows;
``WindowTracker`` / ``SessionTracker`` keep the watermark and the ring of
carry slots; ``StreamingCoordinator`` folds each micro-batch into the
device carry and emits finalized windows exactly once.
"""

from .coordinator import (RunOptions, StreamingCoordinator, StreamReport,
                          carries_from_reference, session_output_key,
                          window_output_key)
from .sessions import Session, SessionTracker
from .source import MicroBatch, StreamSource, write_event_log
from .state import LateEventError, WindowTracker
from .windows import SlidingWindows, TumblingWindows, Window, WindowAssigner

__all__ = [
    "RunOptions", "StreamingCoordinator", "StreamReport",
    "carries_from_reference", "window_output_key", "session_output_key",
    "MicroBatch", "StreamSource", "write_event_log", "LateEventError",
    "WindowTracker", "Session", "SessionTracker", "SlidingWindows",
    "TumblingWindows", "Window", "WindowAssigner",
]

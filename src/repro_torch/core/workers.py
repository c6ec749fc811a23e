"""Record wire format of the workers' sink objects.

Only the encoder the streaming coordinator writes finalized windows with
is carried over: one JSON array per line, ``[key, value]``, compact
separators — the same bytes the reference engine writes, so sink objects
compare byte for byte across the two packages.
"""

from __future__ import annotations

import io
import json
from typing import Any


def _encode_records(records: list[tuple[str, Any]]) -> bytes:
    out = io.BytesIO()
    for k, v in records:
        out.write(json.dumps([k, v], separators=(",", ":")).encode())
        out.write(b"\n")
    return out.getvalue()

"""Event export/import: event store ↔ JSON-lines files (port of the JSON
format of the JAX package's ``tools/export_import.py``; its Parquet
format waits, ROADMAP.md queue 1 item 25).

One API JSON event per line (``core/json_codec.py``), the reference's
json output mode: a file either package exports, the other imports.
Imports go through ``insert_batch`` in batches of 500.
"""

from __future__ import annotations

import json
import logging
from typing import TextIO

from predictionio_tpu_torch.core.json_codec import event_from_json, event_to_json
from predictionio_tpu_torch.storage.base import EventFilter
from predictionio_tpu_torch.storage.registry import Storage

logger = logging.getLogger(__name__)

_BATCH = 500


def export_events(
    storage: Storage,
    app_id: int,
    output: TextIO,
    channel_id: int | None = None,
) -> int:
    """Write every event of (app, channel) as JSON lines; returns count
    (EventsToFile.scala:84-96)."""
    n = 0
    for event in storage.get_events().find(app_id, channel_id, EventFilter()):
        output.write(json.dumps(event_to_json(event)) + "\n")
        n += 1
    logger.info("exported %d events (app %s)", n, app_id)
    return n


class ImportFormatError(ValueError):
    """A line failed to parse/validate. Carries how many events were
    already committed so the operator knows the partial state."""

    def __init__(self, line_no: int, reason: str, imported: int):
        super().__init__(
            f"line {line_no}: {reason} ({imported} event(s) already imported)"
        )
        self.line_no = line_no
        self.imported = imported


def import_events(
    storage: Storage,
    app_id: int,
    input: TextIO,
    channel_id: int | None = None,
) -> int:
    """Read JSON-lines events and batch-insert; returns count
    (FileToEvents.scala:85-101). Raises ImportFormatError on a bad line,
    reporting how much of the file was committed before it."""
    events_dao = storage.get_events()
    batch = []
    n = 0
    for line_no, line in enumerate(input, start=1):
        line = line.strip()
        if not line:
            continue
        try:
            batch.append(event_from_json(json.loads(line)))
        except Exception as e:
            raise ImportFormatError(line_no, str(e), n)
        if len(batch) >= _BATCH:
            events_dao.insert_batch(batch, app_id, channel_id)
            n += len(batch)
            batch = []
    if batch:
        events_dao.insert_batch(batch, app_id, channel_id)
        n += len(batch)
    logger.info("imported %d events (app %s)", n, app_id)
    return n

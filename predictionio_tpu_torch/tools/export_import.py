"""Event export/import: event store ↔ JSON-lines or Parquet files (port
of the JAX package's ``tools/export_import.py``).

JSON lines: one API JSON event per line (``core/json_codec.py``), the
reference's json output mode. Parquet: one column per API JSON field,
strings but ``tags`` (a list of strings), ``properties`` as a JSON
string; ``pyarrow`` is imported only by the Parquet calls. A file either
package exports, the other imports. Imports go through ``insert_batch``
in batches of 500.
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


# ---------------------------------------------------------------------------
# Parquet format (EventsToFile.scala:97-105 `--format parquet`)
# ---------------------------------------------------------------------------

# API JSON field name -> column; all strings except tags (list<string>)
_PARQUET_FIELDS = (
    "eventId", "event", "entityType", "entityId", "targetEntityType",
    "targetEntityId", "properties", "eventTime", "tags", "prId",
    "creationTime",
)


def _parquet_schema():
    import pyarrow as pa

    return pa.schema([(name, pa.list_(pa.string()) if name == "tags" else pa.string())
                      for name in _PARQUET_FIELDS])


def export_events_parquet(
    storage: Storage,
    app_id: int,
    path: str,
    channel_id: int | None = None,
) -> int:
    """Write every event of (app, channel) to one Parquet file in row
    batches of 500; returns count. ImportError without pyarrow."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    schema = _parquet_schema()
    n = 0
    with pq.ParquetWriter(path, schema) as writer:
        rows: list[dict] = []

        def flush():
            nonlocal n
            if rows:
                writer.write_table(pa.Table.from_pylist(rows, schema=schema))
                n += len(rows)
                rows.clear()

        for event in storage.get_events().find(app_id, channel_id, EventFilter()):
            obj = event_to_json(event)
            obj["properties"] = json.dumps(obj.get("properties", {}))
            rows.append({f: obj.get(f) for f in _PARQUET_FIELDS})
            if len(rows) >= _BATCH:
                flush()
        flush()
    logger.info("exported %d events to parquet (app %s)", n, app_id)
    return n


def import_events_parquet(
    storage: Storage,
    app_id: int,
    path: str,
    channel_id: int | None = None,
) -> int:
    """Read a Parquet event file (as :func:`export_events_parquet` writes
    it) and batch-insert; returns count. ImportFormatError for a file
    that is not Parquet or a row that is not an event; ImportError
    without pyarrow."""
    import pyarrow.parquet as pq

    events_dao = storage.get_events()
    try:
        pf = pq.ParquetFile(path)
    except Exception as e:   # ArrowInvalid on input that is not Parquet
        raise ImportFormatError(0, f"not a parquet file: {e}", 0)
    n = 0
    for rb in pf.iter_batches(batch_size=_BATCH):
        batch = []
        for row in rb.to_pylist():
            obj = {k: v for k, v in row.items() if v is not None}
            try:
                if "properties" in obj:
                    obj["properties"] = json.loads(obj["properties"])
                batch.append(event_from_json(obj))
            except Exception as e:
                raise ImportFormatError(n + len(batch) + 1, str(e), n)
        if batch:
            events_dao.insert_batch(batch, app_id, channel_id)
            n += len(batch)
    logger.info("imported %d events from parquet (app %s)", n, app_id)
    return n

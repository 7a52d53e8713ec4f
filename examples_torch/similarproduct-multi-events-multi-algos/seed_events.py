"""Seed MultiSimilarApp: two view-taste clusters plus like/dislike
signals (with one like->dislike flip to exercise latest-wins dedup).

Run it after `python -m predictionio_tpu_torch.cli.pio app new MultiSimilarApp`, from
this directory, under the same ``PIO_FS_BASEDIR``. ``events()`` returns the
events without writing them, so a test or a script can seed a store of its
own from them."""

import sys
from datetime import datetime, timedelta, timezone

import numpy as np

from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.storage.registry import Storage

APP_NAME = "MultiSimilarApp"


def events() -> list[Event]:
    rng = np.random.default_rng(11)
    t0 = datetime.now(timezone.utc)
    out = []

    def emit(event, u, i, minutes=0):
        out.append(Event(event=event, entity_type="user", entity_id=f"u{u}",
                         target_entity_type="item", target_entity_id=f"i{i}",
                         properties=DataMap({}), event_time=t0 + timedelta(minutes=minutes)))

    for u in range(20):
        for i in range(16):
            if i % 2 == u % 2 and rng.random() < 0.85:
                emit("view", u, i)
            if i % 2 == u % 2 and rng.random() < 0.5:
                emit("like", u, i)
    # everyone dislikes item 0 (despite viewing it)
    for u in range(0, 20, 2):
        emit("dislike", u, 0, minutes=5)
    # u2 liked i0 late, then flipped to dislike even later: dislike wins
    emit("like", 2, 0, minutes=6)
    emit("dislike", 2, 0, minutes=7)
    return out


def main() -> None:
    storage = Storage.default()
    app = storage.get_meta_data_apps().get_by_name(APP_NAME)
    if app is None:
        sys.exit(f"app {APP_NAME!r} not found — run "
                 f"`python -m predictionio_tpu_torch.cli.pio app new {APP_NAME}` first")
    seeded = events()
    storage.get_events().insert_batch(seeded, app.id)
    print(f"seeded {len(seeded)} events into {APP_NAME} (app id {app.id})")


if __name__ == "__main__":
    main()

"""Seed RateEcommApp: two taste clusters of rate events (ratings 1-5)
plus one re-rate to exercise latest-wins.

Run it after `python -m predictionio_tpu_torch.cli.pio app new RateEcommApp`, from
this directory, under the same ``PIO_FS_BASEDIR``. ``events()`` returns the
events without writing them, so a test or a script can seed a store of its
own from them."""

import sys
from datetime import datetime, timedelta, timezone

import numpy as np

from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.storage.registry import Storage

APP_NAME = "RateEcommApp"


def events() -> list[Event]:
    rng = np.random.default_rng(17)
    t0 = datetime.now(timezone.utc)
    out = []
    for u in range(20):
        for i in range(16):
            if rng.random() < 0.5:
                same = (i % 2) == (u % 2)
                rating = float(rng.integers(4, 6) if same else rng.integers(1, 3))
                out.append(Event(event="rate", entity_type="user", entity_id=f"u{u}",
                                 target_entity_type="item", target_entity_id=f"i{i}",
                                 properties=DataMap({"rating": rating}), event_time=t0))
    # u0 re-rates i1 later: the 5.0 supersedes whatever came first
    out.append(Event(event="rate", entity_type="user", entity_id="u0",
                     target_entity_type="item", target_entity_id="i1",
                     properties=DataMap({"rating": 5.0}),
                     event_time=t0 + timedelta(minutes=5)))
    return out


def main() -> None:
    storage = Storage.default()
    app = storage.get_meta_data_apps().get_by_name(APP_NAME)
    if app is None:
        sys.exit(f"app {APP_NAME!r} not found — run "
                 f"`python -m predictionio_tpu_torch.cli.pio app new {APP_NAME}` first")
    seeded = events()
    storage.get_events().insert_batch(seeded, app.id)
    print(f"seeded {len(seeded)} rate events into {APP_NAME} (app id {app.id})")


if __name__ == "__main__":
    main()

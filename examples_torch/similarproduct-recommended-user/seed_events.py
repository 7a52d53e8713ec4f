"""Seed RecommendedUserApp: two follow communities with sparse
cross-links.

Run it after `python -m predictionio_tpu_torch.cli.pio app new RecommendedUserApp`, from
this directory, under the same ``PIO_FS_BASEDIR``. ``events()`` returns the
events without writing them, so a test or a script can seed a store of its
own from them."""

import sys

import numpy as np

from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.storage.registry import Storage

APP_NAME = "RecommendedUserApp"


def events() -> list[Event]:
    rng = np.random.default_rng(13)
    out = []
    for u in range(24):
        for v in range(24):
            if u == v:
                continue
            same = (u % 2) == (v % 2)
            if rng.random() < (0.7 if same else 0.02):
                out.append(Event(event="follow", entity_type="user", entity_id=f"u{u}",
                                 target_entity_type="user", target_entity_id=f"u{v}",
                                 properties=DataMap({})))
    return out


def main() -> None:
    storage = Storage.default()
    app = storage.get_meta_data_apps().get_by_name(APP_NAME)
    if app is None:
        sys.exit(f"app {APP_NAME!r} not found — run "
                 f"`python -m predictionio_tpu_torch.cli.pio app new {APP_NAME}` first")
    seeded = events()
    storage.get_events().insert_batch(seeded, app.id)
    print(f"seeded {len(seeded)} follow events into {APP_NAME} (app id {app.id})")


if __name__ == "__main__":
    main()

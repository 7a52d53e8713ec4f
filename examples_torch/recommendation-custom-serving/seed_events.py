"""Seed CustomServingApp with rate events (two taste clusters) through
the storage API.

Run it after `python -m predictionio_tpu_torch.cli.pio app new CustomServingApp`, from
this directory, under the same ``PIO_FS_BASEDIR``. ``events()`` returns the
events without writing them, so a test or a script can seed a store of its
own from them."""

import sys

import numpy as np

from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.storage.registry import Storage

APP_NAME = "CustomServingApp"


def events() -> list[Event]:
    rng = np.random.default_rng(5)
    out = []
    for u in range(16):
        for i in range(12):
            if i % 2 == u % 2 and rng.random() < 0.9:
                out.append(Event(event="rate", entity_type="user", entity_id=f"u{u}",
                                 target_entity_type="item", target_entity_id=f"i{i}",
                                 properties=DataMap({"rating": 5.0})))
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

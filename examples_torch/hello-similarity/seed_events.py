"""Seed $set events for the hello-similarity example.

Run it after `python -m predictionio_tpu_torch.cli.pio app new HelloApp`, from
this directory, under the same ``PIO_FS_BASEDIR``. ``events()`` returns the
events without writing them, so a test or a script can seed a store of its
own from them."""

import sys

from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.storage.registry import Storage

APP_NAME = "HelloApp"
DOCS = {
    "doc1": ["jax", "tpu", "mesh", "sharding"],
    "doc2": ["jax", "tpu", "pallas", "kernel"],
    "doc3": ["http", "rest", "server", "events"],
    "doc4": ["mesh", "sharding", "collective", "tpu"],
}


def events() -> list[Event]:
    return [Event(event="$set", entity_type="doc", entity_id=doc,
                  properties=DataMap({"words": words}))
            for doc, words in DOCS.items()]


def main() -> None:
    storage = Storage.default()
    app = storage.get_meta_data_apps().get_by_name(APP_NAME)
    if app is None:
        sys.exit(f"app {APP_NAME!r} not found — run "
                 f"`python -m predictionio_tpu_torch.cli.pio app new {APP_NAME}` first")
    seeded = events()
    storage.get_events().insert_batch(seeded, app.id)
    print(f"seeded {len(seeded)} docs into {APP_NAME} (app id {app.id})")


if __name__ == "__main__":
    main()

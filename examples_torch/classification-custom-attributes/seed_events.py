"""Seed CustomAttrApp: users whose plan correlates with age/education.

Run it after `python -m predictionio_tpu_torch.cli.pio app new CustomAttrApp`, from
this directory, under the same ``PIO_FS_BASEDIR``. ``events()`` returns the
events without writing them, so a test or a script can seed a store of its
own from them."""

import sys

import numpy as np

from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.storage.registry import Storage

APP_NAME = "CustomAttrApp"


def events() -> list[Event]:
    rng = np.random.default_rng(23)
    genders = ["Male", "Female"]
    educations = ["No School", "High School", "College"]
    out = []
    for u in range(120):
        gender = genders[int(rng.integers(0, 2))]
        education = educations[int(rng.integers(0, 3))]
        age = float(rng.integers(18, 70))
        # plan: college grads and the young skew premium
        premium = (education == "College") or (age < 30 and rng.random() < 0.7)
        out.append(Event(event="$set", entity_type="user", entity_id=f"u{u}",
                         properties=DataMap({"plan": "premium" if premium else "basic",
                                             "gender": gender, "age": age,
                                             "education": education})))
    return out


def main() -> None:
    storage = Storage.default()
    app = storage.get_meta_data_apps().get_by_name(APP_NAME)
    if app is None:
        sys.exit(f"app {APP_NAME!r} not found — run "
                 f"`python -m predictionio_tpu_torch.cli.pio app new {APP_NAME}` first")
    seeded = events()
    storage.get_events().insert_batch(seeded, app.id)
    print(f"seeded {len(seeded)} users into {APP_NAME} (app id {app.id})")


if __name__ == "__main__":
    main()

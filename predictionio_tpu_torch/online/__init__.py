"""The real-time freshness plane: online ALS fold-in between retrains (port
of the JAX package's ``online/``).

- :mod:`~predictionio_tpu_torch.online.follower`: tails the event store
  through ``Events.find_columnar`` from a durable ``(eventTime, id)``
  cursor, exactly once across batch boundaries;
- :mod:`~predictionio_tpu_torch.online.foldin`: recomputes an affected
  user's ALS vector with the closed-form rank x rank solve over the
  user's full interaction set, and gives brand-new items a prior vector;
- :mod:`~predictionio_tpu_torch.online.overlay`: the bounded LRU delta
  table the serving path reads per query, fenced by the deployed base
  model's generation;
- :mod:`~predictionio_tpu_torch.online.service`: the per-server loop that
  wires the three together (``pio deploy --online``), with per-user
  result-cache invalidation.
"""

from predictionio_tpu_torch.online.follower import (  # noqa: F401
    CursorStore,
    EventTailFollower,
    TailCursor,
    resume_columnar,
)
from predictionio_tpu_torch.online.foldin import (  # noqa: F401
    popularity_prior,
    solve_item,
    solve_user,
)
from predictionio_tpu_torch.online.overlay import (  # noqa: F401
    ItemDelta,
    OnlineOverlay,
    UserDelta,
)

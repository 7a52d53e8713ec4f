"""Similarproduct template, no-set-user variant.

Port of the JAX package's ``examples/similarproduct-no-set-user``,
itself the reference's no-set-user variant (reference:
examples/scala-parallel-similarproduct/no-set-user/): the engine must
work when the app NEVER sends ``$set`` user events — users exist only
as the subjects of view events. The reference had to modify its
DataSource (drop the usersRDD properties read) and its ALSAlgorithm
(build the user index from ``data.viewEvents.map(_.user)`` instead of
the user entity set, ALSAlgorithm.scala:75).

In the port that behaviour is the TEMPLATE DEFAULT, as in the JAX
package: ``SimilarProductDataSource.read_training`` derives users from
the view events themselves (``templates/similarproduct.py``), so the
variant is configuration-only — this module re-exports the stock
factory, and the scenario test (tests/test_torch_no_set_user_example.py)
pins the property by training and serving against storage seeded with
ZERO ``$set`` user events.
"""

from __future__ import annotations

from predictionio_tpu_torch.templates.similarproduct import engine_factory

__all__ = ["engine_factory"]

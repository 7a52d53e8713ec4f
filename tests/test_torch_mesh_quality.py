"""``e2/quality.compare_quality(mesh=...)`` in the port against JAX's on
a 4×2 mesh (tests/test_quality_parity.py has no mesh case to mirror).
Both device paths start from JAX's draw, so the device-path metrics are
held to the same-start tolerance of tests/test_torch_quality_parity.py,
and the host metrics (NumPy ALS-WR, popularity, the split) are equal.
The port's mesh lays 8 positions over ``["cpu"] * 8``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

from predictionio_tpu.data import movielens as jml
from predictionio_tpu.e2 import quality as jq
from predictionio_tpu_torch.data import movielens as pml
from predictionio_tpu_torch.e2 import quality as pq
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.parallel.mesh import Mesh

pytestmark = pytest.mark.mesh

#: the same fold and initial factors in both packages, bf16 products
#: summed in another order (tests/test_torch_quality_parity.py)
SAME_INIT_TOL = 5e-3
POINT = dict(rank=10, iterations=10, lam=0.05, k_fold=5)
SMALL = dict(seed=3, num_users=200, num_items=400, num_ratings=12_000)


@pytest.fixture(scope="module")
def points():
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8-device CPU topology")
    jmesh = JaxMesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    mesh = Mesh(np.asarray(["cpu"] * 8, dtype=object).reshape(4, 2), ("data", "model"))
    ds = pml.synthesize_ml100k(**SMALL)

    def jax_draw(num_items, rank, seed):
        return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (num_items, rank),
                                            dtype=jnp.float32) / jnp.sqrt(jnp.float32(rank)))

    patch = pytest.MonkeyPatch()
    patch.setattr(pals, "init_item_factors", jax_draw)
    try:
        port = pq.compare_quality(ds, mesh=mesh, device="cpu", **POINT)
        port_single = pq.compare_quality(ds, device="cpu", **POINT)
    finally:
        patch.undo()
    want = jq.compare_quality(jml.synthesize_ml100k(**SMALL), mesh=jmesh, **POINT)
    return port, port_single, want


def test_mesh_point_equals_the_single_device_point(points):
    """The fused layout solves each row where the unsharded run does."""
    port, port_single, _ = points
    assert port == port_single


def test_mesh_point_equals_jax_mesh_point(points):
    port, _, want = points
    assert list(port) == list(want)
    for key in ("map10_ref", "precision10_ref", "rmse_ref", "map10_popularity",
                "evaluated_users"):
        assert port[key] == want[key], key
    for key in ("rmse_tpu", "map10_tpu", "precision10_tpu", "map10_implicit"):
        assert port[key] == pytest.approx(want[key], abs=SAME_INIT_TOL), key

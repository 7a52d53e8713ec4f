"""The port's native ALS layout packer (``native/bucketize.cc``
``pio_ladder`` behind ``ops/als.ladder_rows``) against the JAX
package's two packing paths on the CPU: the same slabs, array for array
and dtype for dtype, and the module counter that shows which path
served.
"""

from __future__ import annotations

import numpy as np
import pytest

from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch import native
from predictionio_tpu_torch.ops import als as pals


def _power_law(seed=0, users=900, items=400, nnz=6000, power=1.8):
    rng = np.random.default_rng(seed)
    rows = (users * rng.random(nnz) ** power).astype(np.int32)
    cols = (items * rng.random(nnz) ** power).astype(np.int32)
    vals = rng.integers(1, 11, size=nnz).astype(np.float32) / 2.0
    return rows, cols, vals, users, items


def _cases():
    """(rows, cols, vals, num_rows, num_cols) triples, named."""
    out = {"power_law": _power_law(), "power_law_t": None}
    r, c, v, u, i = out["power_law"]
    out["power_law_t"] = (c, r, v, i, u)
    # rows 0, 2, 5 and 7 rate nothing
    out["empty_rows"] = (np.asarray([1, 1, 3, 4, 4, 4, 6], np.int32),
                         np.asarray([0, 2, 1, 0, 1, 2, 2], np.int32),
                         np.arange(1, 8, dtype=np.float32), 8, 3)
    out["one_row"] = (np.zeros(5, np.int32), np.asarray([4, 0, 3, 1, 2], np.int32),
                      np.linspace(0.5, 2.5, 5, dtype=np.float32), 1, 5)
    # row 2 rates 700 items: past one 128-wide chunk and past small
    heavy = np.repeat(np.int32(2), 700)
    out["row_past_width"] = (
        np.concatenate([heavy, np.asarray([0, 1, 1, 3], np.int32)]),
        np.concatenate([np.arange(700, dtype=np.int32), np.asarray([5, 6, 7, 8], np.int32)]),
        np.arange(704, dtype=np.float32) / 7.0, 4, 700)
    # a row past the end of the ladder (2048 chunks of width 4): doubled
    out["past_ladder"] = (np.zeros(9000, np.int32), np.arange(9000, dtype=np.int32) % 50,
                          np.ones(9000, np.float32), 2, 50)
    e = np.zeros(0, np.int32)
    out["nnz_zero"] = (e, e, e.astype(np.float32), 3, 4)
    return out


CASES = _cases()
SHAPES = [(128, 64), (32, 8), (4, 2)]


def _assert_same(got, want):
    assert (got.num_rows, got.num_cols, got.nnz) == (want.num_rows, want.num_cols, want.nnz)
    assert len(got.buckets) == len(want.buckets)
    for gb, wb in zip(got.buckets, want.buckets):
        for name in ("row_ids", "cols", "vals", "deg"):
            g, w = getattr(gb, name), getattr(wb, name)
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("width,small", SHAPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_native_ladder_equals_both_jax_paths(case, width, small):
    r, c, v, nr, nc = CASES[case]
    jcoo = jals.RatingsCOO(r, c, v, nr, nc)
    before = pals.NATIVE_LADDERS
    got = pals.ladder_rows(pals.RatingsCOO(r, c, v, nr, nc), width, small)
    # nnz == 0 returns the empty layout before any packing
    assert pals.NATIVE_LADDERS == before + (len(r) > 0)
    _assert_same(got, jals._ladder_rows_native(jcoo, width, small) if len(r) else
                 jals.ladder_rows(jcoo, width, small))
    _assert_same(got, jals.ladder_rows(jcoo, width, small, use_native=False))
    _assert_same(got, pals.ladder_rows(pals.RatingsCOO(r, c, v, nr, nc), width, small,
                                       use_native=False))


def test_numpy_path_counts_no_native_ladder():
    r, c, v, nr, nc = CASES["power_law"]
    before = pals.NATIVE_LADDERS
    pals.ladder_rows(pals.RatingsCOO(r, c, v, nr, nc), use_native=False)
    assert pals.NATIVE_LADDERS == before


def test_every_rating_lands_once_in_its_row():
    """The native layout holds each row's ratings, in input order, in the
    prefix of one bucket row."""
    r, c, v, nr, nc = CASES["power_law"]
    got = pals.ladder_rows(pals.RatingsCOO(r, c, v, nr, nc))
    seen = np.zeros(nr, dtype=bool)
    for b in got.buckets:
        for slot, row in enumerate(b.row_ids):
            sel = r == row
            d = int(b.deg[slot])
            assert d == sel.sum() and not seen[row]
            seen[row] = True
            np.testing.assert_array_equal(b.cols[slot, :d], c[sel])
            np.testing.assert_array_equal(b.vals[slot, :d], v[sel])
            assert not b.cols[slot, d:].any() and not b.vals[slot, d:].any()
    assert seen.sum() == len(np.unique(r))


def test_library_builds_under_build_dir_beside_the_event_log():
    so = native.library_path("bucketize")
    assert native.load_bucketize() is not None and so.exists()
    assert so.parent == native.BUILD_DIR
    assert so.name.startswith("libbucketize-") and so != native.library_path()


def test_packer_refuses_a_row_past_num_rows():
    """A row index past ``num_rows`` is refused by the packer (None,
    counted nowhere), never written out of bounds."""
    coo = pals.RatingsCOO(np.asarray([0, 5], np.int32), np.asarray([0, 1], np.int32),
                          np.ones(2, np.float32), 2, 2)
    before = pals.NATIVE_LADDERS
    assert pals._ladder_rows_native(coo, 128, 64) is None
    assert pals.NATIVE_LADDERS == before

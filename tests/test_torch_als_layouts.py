"""The port's chunked and bucketed ALS layouts (``predictionio_tpu_torch/
ops/als.py``: ``chunk_rows``, ``bucket_rows`` with its row cap, staging,
the streamed and chunk-accumulating half-steps, ``als_train``'s layout
routing) against the JAX package's ``ops/als.py`` on the CPU: the same
inputs, made with numpy from a seed, through both. Tolerances are stated
per test; "measured" notes what this CPU gave when the bound was set.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.parallel.mesh import Mesh


def _coo(seed=0, users=120, items=80, nnz=3000, power=1.5, negative=False):
    rng = np.random.default_rng(seed)
    rows = (users * rng.random(nnz) ** power).astype(np.int32)
    cols = (items * rng.random(nnz) ** power).astype(np.int32)
    vals = (rng.integers(1, 11, nnz) / 2).astype(np.float32)
    if negative:   # implicit feedback: some dislikes and some zeros
        vals = np.where(rng.random(nnz) < 0.2, -vals, vals)
        vals[rng.random(nnz) < 0.05] = 0.0
    return (jals.RatingsCOO(rows, cols, vals, users, items),
            pals.RatingsCOO(rows, cols, vals, users, items))


SHAPES = {
    "light": dict(seed=0, nnz=3000),
    # rows of several hundred ratings: many chunks per row, capped rows
    "heavy": dict(seed=1, users=40, items=300, nnz=20_000, power=2.0),
}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_item0(num_items, rank, seed):
    """JAX's initial item factors (ops/als.py:1508-1510)."""
    key = jax.random.PRNGKey(seed)
    return np.asarray(jax.random.normal(key, (num_items, rank), dtype=jnp.float32)
                      / jnp.sqrt(jnp.float32(rank)))


def _assert_slabs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in ("row_ids", "cols", "vals", "deg"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


class TestHostLayouts:
    @pytest.mark.parametrize("use_native", [False, True], ids=["numpy", "native"])
    @pytest.mark.parametrize("shape", sorted(SHAPES))
    @pytest.mark.parametrize("sizes", [(512, 128), (16, 4), (64, 16, 4), (8,), (4, 16)])
    def test_chunk_rows_equals_jax(self, use_native, shape, sizes):
        """Both orientations, array for array and dtype for dtype, against
        JAX's same path; NATIVE_CHUNKS counts the native packs only."""
        jc, pc = _coo(**SHAPES[shape])
        for jside, pside in ((jc, pc), (jc.transpose(), pc.transpose())):
            before = pals.NATIVE_CHUNKS
            got = pals.chunk_rows(pside, sizes, use_native=use_native)
            assert pals.NATIVE_CHUNKS == before + use_native
            want = jals.chunk_rows(jside, sizes, use_native=use_native)
            assert (got.num_rows, got.num_cols, got.nnz) == \
                (want.num_rows, want.num_cols, want.nnz)
            _assert_slabs_equal(got.slabs, want.slabs)
            assert sum(int(s.deg.sum()) for s in got.slabs) == pside.nnz

    @pytest.mark.parametrize("use_native", [False, True], ids=["numpy", "native"])
    @pytest.mark.parametrize("shape", sorted(SHAPES))
    @pytest.mark.parametrize("min_len, growth, max_len", [
        (8, 2, None), (4, 3, None), (8, 2, 64), (2, 2, 16), (16, 4, 100),
    ])
    def test_bucket_rows_equals_jax(self, use_native, shape, min_len, growth, max_len):
        """Native against JAX's native, NumPy against JAX's NumPy (the two
        may keep other columns at tied values in a capped row: compared
        in the next test), array for array, both orientations."""
        jc, pc = _coo(**SHAPES[shape])
        for jside, pside in ((jc, pc), (jc.transpose(), pc.transpose())):
            before = pals.NATIVE_BUCKETS
            got = pals.bucket_rows(pside, min_len, growth, max_len, use_native=use_native)
            assert pals.NATIVE_BUCKETS == before + use_native
            want = jals.bucket_rows(jside, min_len, growth, max_len, use_native=use_native)
            assert (got.num_rows, got.num_cols, got.nnz) == \
                (want.num_rows, want.num_cols, want.nnz)
            _assert_slabs_equal(got.buckets, want.buckets)

    @pytest.mark.parametrize("max_len", [4, 16, 64])
    def test_capped_rows_keep_the_top_values_on_both_paths(self, max_len):
        """tests/test_als.py:467: the native cap keeps the multiset of
        values the NumPy cap keeps; uncapped rows hold the same
        (col, val) pairs; padding is zero."""
        _, pc = _coo(**SHAPES["heavy"])
        nat = pals.bucket_rows(pc, 4, 2, max_len)
        py = pals.bucket_rows(pc, 4, 2, max_len, use_native=False)
        assert [b.pad_len for b in nat.buckets] == [b.pad_len for b in py.buckets]
        for bn, bp in zip(nat.buckets, py.buckets):
            on, op = np.argsort(bn.row_ids), np.argsort(bp.row_ids)
            np.testing.assert_array_equal(bn.row_ids[on], bp.row_ids[op])
            np.testing.assert_array_equal(bn.deg[on], bp.deg[op])
            for a, b in zip(on, op):
                d = int(bn.deg[a])
                pa = sorted(zip(bn.cols[a, :d].tolist(), bn.vals[a, :d].tolist()))
                pb = sorted(zip(bp.cols[b, :d].tolist(), bp.vals[b, :d].tolist()))
                if int((pc.rows == bn.row_ids[a]).sum()) <= max_len:
                    assert pa == pb
                else:
                    assert sorted(v for _, v in pa) == sorted(v for _, v in pb)
                    kept = np.sort(pc.vals[pc.rows == bn.row_ids[a]])[::-1][:d]
                    assert sorted(v for _, v in pa) == sorted(kept.tolist())
            assert not (bn.cols * (1 - bn.mask)).any() and not (bn.vals * (1 - bn.mask)).any()

    def test_row_cap_keeps_top_values(self):
        """tests/test_als.py:74 on both packing paths."""
        coo = pals.RatingsCOO(np.zeros(10, np.int32), np.arange(10, dtype=np.int32),
                              np.arange(10, dtype=np.float32), 1, 10)
        for use_native in (True, False):
            b = pals.bucket_rows(coo, min_len=4, max_len=4, use_native=use_native).buckets[0]
            assert set(b.cols[0][b.mask[0] > 0].tolist()) == {6, 7, 8, 9}

    def test_empty_ratings_and_bad_sizes(self):
        e = np.zeros(0, np.int32)
        coo = pals.RatingsCOO(e, e, e.astype(np.float32), 4, 4)
        counts = (pals.NATIVE_BUCKETS, pals.NATIVE_CHUNKS)
        assert pals.bucket_rows(coo).buckets == () and pals.chunk_rows(coo).slabs == ()
        assert (pals.NATIVE_BUCKETS, pals.NATIVE_CHUNKS) == counts
        for sizes in ((), (0, 4)):
            with pytest.raises(ValueError) as want:
                jals.chunk_rows(jals.RatingsCOO(e, e, e.astype(np.float32), 4, 4), sizes)
            with pytest.raises(ValueError, match="invalid chunk sizes") as got:
                pals.chunk_rows(coo, sizes)
            assert str(got.value) == str(want.value)

    def test_packers_refuse_a_row_past_num_rows(self):
        """A row index past ``num_rows``: the native packers refuse it
        (None, counted nowhere), never write out of bounds."""
        coo = pals.RatingsCOO(np.asarray([0, 5], np.int32), np.asarray([0, 1], np.int32),
                              np.ones(2, np.float32), 2, 2)
        counts = (pals.NATIVE_BUCKETS, pals.NATIVE_CHUNKS)
        assert pals._bucket_rows_native(coo, 8, 2, None) is None
        assert pals._chunk_rows_native(coo, (4,)) is None
        assert (pals.NATIVE_BUCKETS, pals.NATIVE_CHUNKS) == counts


class TestStaging:
    @pytest.mark.parametrize("rank, max_slab_elems", [(8, 1 << 12), (32, 1 << 24), (3, 100)])
    def test_chunk_slabs_staged_as_jax_pads_them(self, rank, max_slab_elems):
        jc, pc = _coo(seed=3, **{k: v for k, v in SHAPES["heavy"].items() if k != "seed"})
        want = jals.chunk_rows(jc, (64, 16))
        staged = pals.stage_chunks(pals.chunk_rows(pc, (64, 16)), rank, max_slab_elems,
                                   device="cpu")
        assert (staged.num_rows, staged.num_cols, staged.nnz) == (40, 300, pc.nnz)
        assert len(staged.slabs) == len(want.slabs) == 2
        for js, ss, ps in zip(want.slabs, staged.slabs, pals.chunk_rows(pc, (64, 16)).slabs):
            rids, cols, vals, deg = jals.pad_chunk_slab(js, rank, 1, max_slab_elems)
            for got, arr in zip(pals.pad_chunk_slab(ps, rank, max_slab_elems),
                                (rids, cols, vals, deg)):
                assert got.dtype == arr.dtype
                np.testing.assert_array_equal(got, arr)
            np.testing.assert_array_equal(ss.row_ids.numpy(), rids)
            np.testing.assert_array_equal(ss.cols.numpy(), cols)
            np.testing.assert_array_equal(ss.vals.numpy(), vals)
            np.testing.assert_array_equal(ss.deg.numpy(), deg)

    def test_power_of_growth_buckets_staged_as_jax_pads_them(self):
        jc, pc = _coo(seed=4)
        staged = pals.stage_buckets(pals.bucket_rows(pc, 4, 2, 32), 8, max_slab_elems=1 << 10,
                                    device="cpu")
        for jb, sb in zip(jals.bucket_rows(jc, 4, 2, 32).buckets, staged.buckets):
            cols, vals, deg = jals.pad_bucket_slabs(jb, 8, 1, 1 << 10)
            np.testing.assert_array_equal(sb.cols.numpy(), cols)
            np.testing.assert_array_equal(sb.vals.numpy(), vals)
            np.testing.assert_array_equal(sb.deg.numpy(), deg)
            np.testing.assert_array_equal(sb.row_ids.numpy(), jb.row_ids)

    @pytest.mark.parametrize("rank, solver, cg_steps", [
        (4, "cg", None), (32, "cg", None), (200, "cg", None), (32, "cg", 24),
        (32, "cholesky", None),
    ])
    def test_half_step_flops_equals_jax(self, rank, solver, cg_steps):
        """Exactly JAX's figures on the chunked and the bucketed layouts
        (the chunked executed work counts every row's solve)."""
        jc, pc = _coo(seed=2, nnz=5000)
        for jl, pl in ((jals.chunk_rows(jc, (64, 16)), pals.chunk_rows(pc, (64, 16))),
                       (jals.chunk_rows(jc.transpose()), pals.chunk_rows(pc.transpose())),
                       (jals.bucket_rows(jc, 4), pals.bucket_rows(pc, 4))):
            assert pals.half_step_flops(pl, rank, cg_steps=cg_steps, solver=solver) == \
                jals.half_step_flops(jl, rank, cg_steps=cg_steps, solver=solver)

    def test_chunked_flops_accounting(self):
        """tests/test_als.py:153: row 0 (degree 10) makes an 8-chunk and a
        4-chunk of degree 2, row 1 a 4-chunk of degree 3."""
        rows = np.repeat(np.array([0, 1], dtype=np.int32), [10, 3])
        coo = pals.RatingsCOO(rows, np.arange(13, dtype=np.int32),
                              np.ones(13, dtype=np.float32), 2, 13)
        K = 4
        fl = pals.half_step_flops(pals.chunk_rows(coo, sizes=(8, 4)), K)
        per_entry = 2 * K * K + 2 * K
        assert fl["useful_flops"] == pytest.approx(13 * per_entry + 2 * (K ** 3 / 3 + 2 * K * K))
        assert fl["executed_flops"] == pytest.approx(
            (8 + 4 + 4) * per_entry + 2 * min(K + 4, 16) * (2 * K * K + 8 * K))


def _layouts(layout, jc, pc, rank, streamed):
    """The JAX and the port's host layouts of one side; the port's staged
    on the CPU unless ``streamed``."""
    if layout == "chunked":
        return (jals.chunk_rows(jc, (16, 4)),
                pals.chunk_rows(pc, (16, 4)) if streamed else
                pals.stage_chunks(pals.chunk_rows(pc, (16, 4)), rank, device="cpu"))
    host = pals.bucket_rows(pc, 4, 2, 24)
    return (jals.bucket_rows(jc, 4, 2, 24),
            host if streamed else pals.stage_buckets(host, rank, device="cpu"))


class TestSolveHalf:
    @pytest.mark.parametrize("streamed", [False, True], ids=["staged", "host"])
    @pytest.mark.parametrize("matmul_dtype, cg_matvec_dtype", [
        ("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16"),
    ])
    @pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
    @pytest.mark.parametrize("layout", ["chunked", "bucketed"])
    def test_solve_half_equals_jax(self, layout, implicit, matmul_dtype, cg_matvec_dtype,
                                   streamed):
        """ops/als.py:1178 on the chunked layout (accumulate, then one CG)
        and on capped power-of-growth buckets, staged or from the host (the
        bucketed host layout streams one bucket at a time): within 1e-5
        relative of JAX, 1e-4 with the bf16 matvec (measured ~2e-7 /
        ~1e-6: only the summation order differs). Unrated rows are 0."""
        jc, pc = _coo(seed=4, negative=implicit)
        V = (np.random.default_rng(5).standard_normal((80, 8)) / 3).astype(np.float32)
        kw = dict(implicit=implicit, alpha=2.0, matmul_dtype=matmul_dtype,
                  cg_matvec_dtype=cg_matvec_dtype)
        jl, pl = _layouts(layout, jc, pc, 8, streamed)
        want = np.asarray(jals.solve_half(jnp.asarray(V), jl, 8, 0.05, **kw))
        got = pals.solve_half(torch.from_numpy(V), pl, 8, 0.05, **kw).numpy()
        assert _rel(got, want) < (1e-4 if cg_matvec_dtype == "bfloat16" else 1e-5)
        assert not got[np.setdiff1d(np.arange(120), pc.rows)].any()

    @pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
    def test_bucketed_cholesky_and_slab_cap_equal_jax(self, implicit):
        """solver="cholesky" and a small ``max_slab_elems`` (many slabs a
        bucket) on the streamed bucketed path: within 1e-5 of JAX."""
        jc, pc = _coo(seed=6, negative=implicit)
        V = (np.random.default_rng(7).standard_normal((80, 6)) / 3).astype(np.float32)
        kw = dict(implicit=implicit, alpha=2.0, solver="cholesky", max_slab_elems=256)
        want = np.asarray(jals.solve_half(jnp.asarray(V), jals.bucket_rows(jc, 8), 6, 0.05,
                                          **kw))
        got = pals.solve_half(torch.from_numpy(V), pals.bucket_rows(pc, 8), 6, 0.05,
                              **kw).numpy()
        assert _rel(got, want) < 1e-5

    @pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
    def test_chunked_half_step_equals_float64(self, implicit):
        """tests/test_als.py:188: rows split over many chunks against the
        direct float64 per-row solve (relative 1e-4; measured ~1e-6)."""
        rng = np.random.default_rng(3)
        mask = rng.random((25, 30)) < 0.5
        r, c = np.nonzero(mask)
        v = rng.uniform(1.0, 5.0, size=len(r)).astype(np.float32)
        coo = pals.RatingsCOO(r.astype(np.int32), c.astype(np.int32), v, 25, 30)
        V = rng.standard_normal((30, 6)).astype(np.float32)
        got = pals.solve_half(torch.from_numpy(V), pals.chunk_rows(coo, (8, 4)), 6, 0.1,
                              implicit=implicit, alpha=10.0, cg_steps=24).numpy()
        Vd = V.astype(np.float64)
        for u in range(25):
            sel = coo.rows == u
            F, rr = Vd[coo.cols[sel]], v[sel].astype(np.float64)
            if implicit:
                w = 10.0 * rr
                A = Vd.T @ Vd + (F * w[:, None]).T @ F + 0.1 * np.eye(6)
                b = ((1.0 + w)[:, None] * F).sum(0)
            else:
                A = F.T @ F + 0.1 * sel.sum() * np.eye(6)
                b = (rr[:, None] * F).sum(0)
            want = np.linalg.solve(A, b)
            assert np.linalg.norm(got[u] - want) < 1e-4 * np.linalg.norm(want)

    def test_options_are_checked_as_jax_checks_them(self):
        jc, pc = _coo()
        V = np.zeros((80, 4), np.float32)
        with pytest.raises(ValueError) as want:
            jals.solve_half(jnp.asarray(V), jals.chunk_rows(jc), 4, 0.1, solver="cholesky")
        for layout in (pals.chunk_rows(pc), pals.stage_chunks(pals.chunk_rows(pc), 4,
                                                              device="cpu")):
            with pytest.raises(ValueError, match="cholesky") as got:
                pals.solve_half(torch.from_numpy(V), layout, 4, 0.1, solver="cholesky")
            assert str(got.value) == str(want.value)
        with pytest.raises(ValueError, match="staged over another mesh"):
            pals.solve_half(torch.from_numpy(V), pals.stage_buckets(pals.bucket_rows(pc), 4,
                                                                    device="cpu"), 4, 0.1,
                            mesh=Mesh(["cpu", "cpu"], ("data",)))
        # without a mesh shard_factors has no effect, as in the JAX package
        torch.testing.assert_close(
            pals.solve_half(torch.from_numpy(V), pals.bucket_rows(pc), 4, 0.1,
                            shard_factors=True),
            pals.solve_half(torch.from_numpy(V), pals.bucket_rows(pc), 4, 0.1), rtol=0, atol=0)

    @pytest.mark.parametrize("layout, streamed", [
        ("chunked", False), ("chunked", True), ("bucketed", False), ("bucketed", True),
    ])
    def test_half_steps_read_no_device_value_on_the_host(self, monkeypatch, layout,
                                                         streamed):
        """As tests/test_torch_als.py checks the fused loop: a half-step
        never converts a device value to a host value (each would wait
        for the card), staged or streamed, explicit or implicit."""
        jc, pc = _coo(seed=12)
        _, pl = _layouts(layout, jc, pc, 4, streamed)
        V = pals.init_item_factors(80, 4, 0)

        def refuse(*a, **k):
            raise AssertionError("host read inside a half-step")

        for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__float__", "__int__",
                     "__index__"):
            monkeypatch.setattr(torch.Tensor, name, refuse)
        for implicit in (False, True):
            pals.solve_half(V, pl, 4, 0.05, implicit=implicit, alpha=2.0,
                            matmul_dtype="bfloat16", cg_matvec_dtype="bfloat16")

    @pytest.mark.parametrize("layout", ["chunked", "bucketed"])
    def test_tf32_setting_does_not_reach_the_f32_route(self, monkeypatch, layout):
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        seen = []
        real = pals._cg_solve_batched

        def spy(*a, **k):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return real(*a, **k)

        monkeypatch.setattr(pals, "_cg_solve_batched", spy)
        jc, pc = _coo()
        _, pl = _layouts(layout, jc, pc, 4, True)
        pals.solve_half(torch.ones(80, 4), pl, 4, 0.1, implicit=True)
        assert seen and not any(seen)
        assert torch.backends.cuda.matmul.allow_tf32 is True


TRAIN_CASES = {
    "chunked": dict(layout="chunked", chunk_sizes=(16, 4)),
    "chunked_default_sizes": dict(layout="chunked"),
    "bucketed": dict(layout="bucketed"),
    "bucketed_capped": dict(layout="bucketed", max_row_len=24, min_bucket=4),
    "auto_capped": dict(max_row_len=24, bucket_growth=3),
    "auto_streamed": dict(hbm_resident=False),
    "bucketed_streamed_capped": dict(layout="bucketed", hbm_resident=False, max_row_len=32),
}


class TestAlsTrain:
    @pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
    @pytest.mark.parametrize("case", sorted(TRAIN_CASES))
    def test_f32_training_equals_jax(self, case, implicit):
        """JAX's item0 injected, f32 build and matvec, 5 iterations: both
        tables within 1e-4 relative of JAX's (measured ~1e-6 to ~4e-6:
        the alternation carries the summation-order differences on)."""
        jc, pc = _coo(seed=6, negative=implicit)
        kw = dict(implicit=implicit, alpha=2.0, matmul_dtype="float32",
                  cg_matvec_dtype="float32", **TRAIN_CASES[case])
        want = jals.als_train(jc, 8, iterations=5, lam=0.05, seed=3, **kw)
        got = pals.als_train(pc, 8, iterations=5, lam=0.05, item0=_jax_item0(80, 8, 3),
                             device="cpu", **kw)
        assert got.user.shape == (120, 8) and got.item.shape == (80, 8)
        assert _rel(got.user, want.user) < 1e-4 and _rel(got.item, want.item) < 1e-4

    @pytest.mark.parametrize("layout", ["chunked", "bucketed"])
    def test_bf16_training_equals_jax_by_rmse(self, layout):
        """The template default (bf16 build, "auto" matvec): the RMSE
        within 1e-3 of JAX's (measured ~1e-5), the items within 1e-2."""
        jc, pc = _coo(seed=8)
        want = jals.als_train(jc, 8, iterations=5, lam=0.05, seed=3, layout=layout)
        got = pals.als_train(pc, 8, iterations=5, lam=0.05, item0=_jax_item0(80, 8, 3),
                             layout=layout, device="cpu")
        assert abs(pals.rmse(got, pc) - jals.rmse(want, jc)) < 1e-3
        assert _rel(got.item, want.item) < 1e-2

    def test_three_layouts_agree(self):
        """tests/test_als.py:223: chunked, bucketed and fused train the same
        estimator: within 5e-3, as there (measured ~1e-5)."""
        rng = np.random.default_rng(9)
        mask = rng.random((30, 20)) < 0.3
        r, c = np.nonzero(mask)
        coo = pals.RatingsCOO(r.astype(np.int32), c.astype(np.int32),
                              rng.uniform(1.0, 5.0, size=len(r)).astype(np.float32), 30, 20)
        out = {layout: pals.als_train(coo, 6, iterations=6, lam=0.05, seed=2, layout=layout,
                                      chunk_sizes=(8, 4), device="cpu")
               for layout in ("chunked", "bucketed", "fused")}
        for a, b in (("chunked", "bucketed"), ("fused", "chunked")):
            for side in ("user", "item"):
                np.testing.assert_allclose(getattr(out[a], side).numpy(),
                                           getattr(out[b], side).numpy(), rtol=5e-3, atol=5e-3)

    @pytest.mark.parametrize("kw", [
        dict(layout="chunkd"),
        dict(layout="chunked", max_row_len=4),
        dict(layout="chunked", hbm_resident=False),
        dict(layout="fused", hbm_resident=False),
        dict(layout="fused", max_row_len=8),
        dict(layout="chunked", solver="cholesky"),
    ])
    def test_validation_messages_equal_jax(self, kw):
        jc, pc = _coo(users=5, items=5, nnz=12)
        with pytest.raises(ValueError) as want:
            jals.als_train(jc, 4, iterations=1, **kw)
        with pytest.raises(ValueError) as got:
            pals.als_train(pc, 4, iterations=1, device="cpu", **kw)
        assert str(got.value) == str(want.value)

    @pytest.mark.parametrize("kw, packer", [
        (dict(), "ladder_rows"), (dict(max_row_len=16), "bucket_rows"),
        (dict(hbm_resident=False), "bucket_rows"), (dict(layout="chunked"), "chunk_rows"),
        (dict(layout="bucketed", chunked_acc_budget=1), "bucket_rows"),
    ])
    def test_routing_equals_jax(self, monkeypatch, kw, packer):
        """"auto" takes bucketed when a bucketed-only knob is set, else
        fused, as JAX's does (ops/als.py:1415-1419): the packer each
        package calls, counted on both."""
        jc, pc = _coo(seed=10)
        calls = []
        for mod, tag in ((jals, "jax"), (pals, "port")):
            for name in ("ladder_rows", "bucket_rows", "chunk_rows"):
                real = getattr(mod, name)
                monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, _t=tag, **k: (
                    calls.append((_t, _n)), _r(*a, **k))[1])
        jals.als_train(jc, 4, iterations=1, **kw)
        pals.als_train(pc, 4, iterations=1, device="cpu", **kw)
        assert calls == [("jax", packer)] * 2 + [("port", packer)] * 2

    def test_zero_rating_rows_get_zero_factors(self):
        """tests/test_als.py:265 on the two layouts."""
        coo = pals.RatingsCOO(np.array([0, 2], np.int32), np.array([0, 1], np.int32),
                              np.array([3.0, 4.0], np.float32), 4, 2)
        for layout in ("chunked", "bucketed"):
            u = pals.als_train(coo, 3, iterations=2, lam=0.1, layout=layout,
                               device="cpu").user.numpy()
            assert not u[[1, 3]].any() and u[0].any()

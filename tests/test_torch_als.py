"""The port's ALS (``predictionio_tpu_torch/ops/als.py``) against the JAX
package's ``ops/als.py`` on the CPU: the same inputs, made with numpy
from a seed, through both. Tolerances are stated per test; "measured"
notes what this CPU gave when the bound was set.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.ops import als as pals


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


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_item0(num_items, rank, seed):
    """JAX's initial item factors (ops/als.py:1443-1446)."""
    key = jax.random.PRNGKey(seed)
    return np.asarray(jax.random.normal(key, (num_items, rank), dtype=jnp.float32)
                      / jnp.sqrt(jnp.float32(rank)))


def _spd(seed, batch, rank, deg_lo, deg_hi, lam):
    """ALS-WR normal systems, as tests/test_als.py builds them."""
    rng = np.random.default_rng(seed)
    A = np.empty((batch, rank, rank), np.float32)
    b = np.empty((batch, rank), np.float32)
    for j in range(batch):
        deg = int(rng.integers(deg_lo, deg_hi))
        F = (rng.standard_normal((deg, rank)) / np.sqrt(rank)).astype(np.float32)
        r = rng.integers(1, 6, size=deg).astype(np.float32)
        A[j] = F.T @ F + lam * deg * np.eye(rank, dtype=np.float32)
        b[j] = F.T @ r
    return A, b


class TestLayout:
    @pytest.mark.parametrize("use_native", [False, True], ids=["numpy", "native"])
    @pytest.mark.parametrize("shape", [
        dict(seed=0, nnz=3000),
        dict(seed=1, users=40, items=300, nnz=20_000, power=2.0),   # heavy rows past the ladder
    ], ids=["light", "heavy"])
    @pytest.mark.parametrize("width, small", [(128, 64), (16, 8)])
    def test_ladder_rows_equals_jax(self, use_native, shape, width, small):
        """Array for array, both orientations, against JAX's NumPy path
        and its native packer."""
        jc, pc = _coo(**shape)
        for jside, pside in ((jc, pc), (jc.transpose(), pc.transpose())):
            want = jals.ladder_rows(jside, width, small, use_native=use_native)
            got = pals.ladder_rows(pside, width, small, use_native=use_native)
            assert (got.num_rows, got.num_cols, got.nnz) == (want.num_rows, want.num_cols,
                                                            want.nnz)
            assert len(got.buckets) == len(want.buckets) > 1
            for g, w in zip(got.buckets, want.buckets):
                for name in ("row_ids", "cols", "vals", "deg"):
                    np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
                np.testing.assert_array_equal(g.mask, w.mask)

    def test_empty_ratings(self):
        e = np.zeros(0, np.int32)
        got = pals.ladder_rows(pals.RatingsCOO(e, e, e.astype(np.float32), 3, 4))
        assert got.buckets == () and (got.num_rows, got.num_cols, got.nnz) == (3, 4, 0)

    @pytest.mark.parametrize("n, pad_len, rank, data_axis, max_slab_elems", [
        (138_493, 64, 32, 1, 1 << 24), (89_034, 128, 32, 1, 1 << 24),
        (1, 98_304, 32, 1, 1 << 24), (9_873, 512, 200, 1, 1 << 24),
        (5, 64, 8, 4, 1 << 10), (1000, 4096, 3, 1, 1 << 12),
    ])
    def test_slab_shape_equals_jax(self, n, pad_len, rank, data_axis, max_slab_elems):
        assert pals._slab_shape(n, pad_len, rank, data_axis, max_slab_elems) == \
            jals._slab_shape(n, pad_len, rank, data_axis, max_slab_elems)

    @pytest.mark.parametrize("rank, solver, cg_steps", [
        (8, "cg", None), (32, "cg", None), (200, "cg", None), (32, "cg", 24),
        (32, "cholesky", None),
    ])
    def test_half_step_flops_equals_jax(self, rank, solver, cg_steps):
        jc, pc = _coo(seed=2, nnz=5000)
        for jb, pb in ((jals.ladder_rows(jc), pals.ladder_rows(pc)),
                       (jals.ladder_rows(jc.transpose()), pals.ladder_rows(pc.transpose()))):
            assert pals.half_step_flops(pb, rank, cg_steps=cg_steps, solver=solver) == \
                jals.half_step_flops(jb, rank, cg_steps=cg_steps, solver=solver)
        with pytest.raises(ValueError, match="solver"):
            pals.half_step_flops(pals.ladder_rows(pc), rank, solver="lu")

    def test_staged_slabs_equal_jax_padding(self):
        """The slabs go to the device padded as JAX pads them."""
        jc, pc = _coo(seed=3)
        staged = pals.stage_buckets(pals.ladder_rows(pc), 8, max_slab_elems=1 << 12,
                                    device="cpu")
        for jb, sb in zip(jals.ladder_rows(jc).buckets, staged.buckets):
            cols, vals, deg = jals.pad_bucket_slabs(jb, 8, 1, 1 << 12)
            np.testing.assert_array_equal(sb.cols.numpy(), cols)
            np.testing.assert_array_equal(sb.vals.numpy(), vals)
            np.testing.assert_array_equal(sb.deg.numpy(), deg)
            np.testing.assert_array_equal(sb.row_ids.numpy(), jb.row_ids)
            assert (sb.n, sb.pad_len) == (len(jb.row_ids), jb.pad_len)


class TestSolvers:
    @pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_matvec"])
    @pytest.mark.parametrize("rank, deg, lam, steps", [
        (8, (20, 60), 0.08, None), (32, (30, 200), 0.01, None), (48, (100, 400), 0.05, 24),
    ])
    def test_cg_equals_jax(self, bf16, rank, deg, lam, steps):
        """f32: within 1e-5 relative of JAX (measured ~1e-7). bf16 matvec:
        the bf16-rounded A and p multiply exactly in f32 on both sides, so
        only the summation order differs: within 1e-4 (measured ~1e-6)."""
        A, b = _spd(rank, 16, rank, *deg, lam)
        want = np.asarray(jals._cg_solve_batched(jnp.asarray(A), jnp.asarray(b),
                                                 steps=steps, bf16_matvec=bf16))
        got = pals._cg_solve_batched(torch.from_numpy(A), torch.from_numpy(b),
                                     steps=steps, bf16_matvec=bf16).numpy()
        assert _rel(got, want) < (1e-4 if bf16 else 1e-5)

    def test_cg_survives_singular_system(self):
        """tests/test_als.py:805: on a rank-1, near-zero system CG takes a
        zero step where p·Ap <= 0 instead of an exploding one, so the
        iterate stays finite, as JAX's does. The iterates themselves are
        rounding noise on such a system and are not compared."""
        rng = np.random.default_rng(2)
        v = rng.standard_normal(16).astype(np.float32)
        A = (np.outer(v, v)[None] * 1e-4).astype(np.float32)
        b = rng.standard_normal((1, 16)).astype(np.float32)
        for bf16 in (False, True):
            got = pals._cg_solve_batched(torch.from_numpy(A), torch.from_numpy(b),
                                         steps=16, bf16_matvec=bf16).numpy()
            want = np.asarray(jals._cg_solve_batched(jnp.asarray(A), jnp.asarray(b),
                                                     steps=16, bf16_matvec=bf16))
            assert np.isfinite(got).all() and np.isfinite(want).all()

    def test_cho_solve_equals_jax_and_float64(self):
        A, b = _spd(5, 12, 24, 30, 90, 0.05)
        got = pals._cho_solve_batched(torch.from_numpy(A), torch.from_numpy(b)).numpy()
        want = np.asarray(jals._cho_solve_batched(jnp.asarray(A), jnp.asarray(b)))
        exact = np.linalg.solve(A.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
        assert _rel(got, want) < 1e-5 and _rel(got, exact) < 1e-5

    def test_cholesky_of_an_indefinite_matrix_is_nan_not_an_error(self):
        A = -np.eye(4, dtype=np.float32)[None]
        x = pals._cho_solve_batched(torch.from_numpy(A), torch.ones(1, 4))
        assert torch.isnan(x).all()

    @pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
    @pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
    @pytest.mark.parametrize("solver", ["cg", "cholesky"])
    def test_normal_eq_solve_equals_jax(self, implicit, bf16, solver):
        """One slab with negative and zero ratings and zero-degree (pad)
        rows. Within 1e-5 relative (measured ~2e-7); pad rows exactly 0."""
        rng = np.random.default_rng(7)
        B, L, K, n_cols = 12, 32, 8, 50
        V = (rng.standard_normal((n_cols, K)) / 3).astype(np.float32)
        c = rng.integers(0, n_cols, (B, L)).astype(np.int32)
        d = rng.integers(0, L + 1, B).astype(np.int32)
        d[[2, 7]] = 0
        v = (rng.integers(-4, 11, (B, L)) / 2).astype(np.float32)
        v = np.where(np.arange(L)[None, :] < d[:, None], v, 0.0).astype(np.float32)
        mm = jnp.bfloat16 if bf16 else jnp.float32
        Vj = jnp.asarray(V)
        gram = jnp.einsum("ik,im->km", Vj, Vj, precision=jax.lax.Precision.HIGHEST)
        want = np.asarray(jals._normal_eq_solve(
            Vj.astype(mm), jnp.asarray(c), jnp.asarray(v), jnp.asarray(d), 0.05, 2.0,
            gram if implicit else None, implicit, mm,
            None if bf16 else jals._HI, None, solver))
        Vt = torch.from_numpy(V)
        got = pals._normal_eq_solve(
            Vt.to(torch.bfloat16) if bf16 else Vt, torch.from_numpy(c), torch.from_numpy(v),
            torch.from_numpy(d), 0.05, 2.0, Vt.T @ Vt if implicit else None, implicit, None,
            solver).numpy()
        assert _rel(got, want) < 1e-5
        assert not got[[2, 7]].any()

    def test_resolve_cg_matvec_equals_jax(self):
        for dtype in ("auto", "float32", "bfloat16"):
            for rank in (8, 63, 64, 200):
                assert pals._resolve_cg_matvec(dtype, rank) == \
                    jals._resolve_cg_matvec(dtype, rank)
        with pytest.raises(ValueError, match="cg_matvec_dtype"):
            pals._resolve_cg_matvec("fp8", 200)


class TestSolveHalf:
    @pytest.mark.parametrize("matmul_dtype, solver, cg_matvec_dtype", [
        ("float32", "cg", "float32"), ("float32", "cholesky", "float32"),
        ("bfloat16", "cg", "float32"), ("bfloat16", "cg", "bfloat16"),
    ])
    @pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
    def test_solve_half_equals_jax(self, matmul_dtype, solver, cg_matvec_dtype, implicit):
        """ops/als.py:1178 with an explicit V, host buckets (staged per
        call) and staged ones: within 1e-5 relative, 1e-4 with the bf16
        matvec (measured ~2e-7 / ~1e-6)."""
        jc, pc = _coo(seed=4, negative=implicit)
        V = (np.random.default_rng(5).standard_normal((80, 8)) / 3).astype(np.float32)
        kw = dict(implicit=implicit, alpha=2.0, matmul_dtype=matmul_dtype, solver=solver,
                  cg_matvec_dtype=cg_matvec_dtype)
        want = np.asarray(jals.solve_half(jnp.asarray(V), jals.ladder_rows(jc), 8, 0.05, **kw))
        host = pals.ladder_rows(pc)
        tol = 1e-4 if cg_matvec_dtype == "bfloat16" else 1e-5
        for buckets in (host, pals.stage_buckets(host, 8, device="cpu")):
            got = pals.solve_half(torch.from_numpy(V), buckets, 8, 0.05, **kw).numpy()
            assert _rel(got, want) < tol
        assert not got[np.setdiff1d(np.arange(120), pc.rows)].any()   # unrated rows

    def test_options_are_checked(self):
        _, pc = _coo()
        V = torch.zeros(80, 4)
        for kw, match in ((dict(matmul_dtype="float16"), "matmul_dtype"),
                          (dict(solver="lu"), "solver"),
                          (dict(cg_matvec_dtype="x"), "cg_matvec_dtype")):
            with pytest.raises(ValueError, match=match):
                pals.solve_half(V, pals.ladder_rows(pc), 4, 0.1, **kw)
        with pytest.raises(NotImplementedError, match="item 15"):
            pals.solve_half(V, pals.ladder_rows(pc), 4, 0.1, shard_factors=True)


class TestAlsTrain:
    @pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
    def test_f32_half_steps_and_iterations_equal_jax(self, implicit):
        """JAX's item0 injected, f32 build and matvec: each half-step
        within 1e-5 relative Frobenius error of JAX's on the same input
        (measured ~2e-7), the factors after 5 iterations within 1e-4
        (measured ~3e-6: the alternation carries the differences on)."""
        jc, pc = _coo(seed=6, negative=implicit)
        item0 = _jax_item0(80, 8, 3)
        kw = dict(implicit=implicit, alpha=2.0, matmul_dtype="float32",
                  cg_matvec_dtype="float32")
        V = item0
        for half in range(4):
            side_j, side_p = (jc, pc) if half % 2 == 0 else (jc.transpose(), pc.transpose())
            want = np.asarray(jals.solve_half(jnp.asarray(V), jals.ladder_rows(side_j), 8,
                                              0.05, **kw))
            got = pals.solve_half(torch.tensor(V), pals.ladder_rows(side_p), 8, 0.05,
                                  **kw).numpy()
            assert _rel(got, want) < 1e-5, half
            V = want
        want = jals.als_train(jc, 8, iterations=5, lam=0.05, seed=3, **kw)
        got = pals.als_train(pc, 8, iterations=5, lam=0.05, item0=item0, device="cpu", **kw)
        assert _rel(got.user, want.user) < 1e-4 and _rel(got.item, want.item) < 1e-4

    def test_bf16_training_equals_jax_by_rmse(self):
        """The template default (bf16 build, "auto" matvec): the factors
        part by summation order (measured ~1e-3 relative after 5
        iterations), so the gate is the RMSE: within 1e-3 of JAX's
        (measured ~2e-5; the JAX suite's bf16-vs-f32 gate is 0.02)."""
        jc, pc = _coo(seed=8)
        item0 = _jax_item0(80, 8, 3)
        want = jals.als_train(jc, 8, iterations=5, lam=0.05, seed=3)
        got = pals.als_train(pc, 8, iterations=5, lam=0.05, item0=item0, device="cpu")
        assert abs(pals.rmse(got, pc) - jals.rmse(want, jc)) < 1e-3
        assert _rel(got.item, want.item) < 1e-2

    def test_cholesky_training_equals_jax(self):
        jc, pc = _coo(seed=9)
        item0 = _jax_item0(80, 6, 1)
        kw = dict(matmul_dtype="float32", solver="cholesky")
        want = jals.als_train(jc, 6, iterations=4, lam=0.05, seed=1, **kw)
        got = pals.als_train(pc, 6, iterations=4, lam=0.05, item0=item0, device="cpu", **kw)
        assert _rel(got.user, want.user) < 1e-4

    def test_default_item0_is_the_seeded_cpu_draw(self):
        _, pc = _coo(seed=10)
        a = pals.als_train(pc, 4, iterations=2, seed=11, device="cpu")
        b = pals.als_train(pc, 4, iterations=2, device="cpu",
                           item0=pals.init_item_factors(80, 4, 11))
        assert torch.equal(a.user, b.user) and torch.equal(a.item, b.item)
        draw = pals.init_item_factors(80, 4, 11)
        want = torch.randn((80, 4), generator=torch.Generator().manual_seed(11)) / 2.0
        assert torch.equal(draw, want)

    def test_training_reads_no_device_value_on_the_host(self, monkeypatch):
        """The loop never converts a device value to a host value (one
        such read per slab would wait for the card every time)."""
        _, pc = _coo(seed=12)
        dev_u = pals.stage_buckets(pals.ladder_rows(pc), 4, device="cpu")
        dev_i = pals.stage_buckets(pals.ladder_rows(pc.transpose()), 4, device="cpu")
        item0 = pals.init_item_factors(80, 4, 0)

        def refuse(*a, **k):
            raise AssertionError("host read inside the training loop")

        for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__float__", "__int__",
                     "__index__"):
            monkeypatch.setattr(torch.Tensor, name, refuse)
        for implicit, solver in ((False, "cg"), (True, "cg"), (False, "cholesky")):
            pals._als_iterate_fused(item0, dev_u, dev_i, 2, 0.05, 2.0, implicit, bf16=True,
                                    solver=solver, cg_bf16=True)

    def test_layout_and_option_errors(self):
        _, pc = _coo()
        for layout in ("chunked", "bucketed"):
            with pytest.raises(NotImplementedError, match="item 16"):
                pals.als_train(pc, 4, layout=layout, device="cpu")
        with pytest.raises(ValueError, match="layout"):
            pals.als_train(pc, 4, layout="ragged", device="cpu")
        with pytest.raises(NotImplementedError, match="item 15"):
            pals.als_train(pc, 4, shard_factors=True, device="cpu")
        with pytest.raises(ValueError, match="item0"):
            pals.als_train(pc, 4, item0=np.zeros((3, 4), np.float32), device="cpu")
        f = pals.als_train(pc, 4, iterations=1, layout="fused", device="cpu")
        assert f.user.shape == (120, 4) and f.item.device.type == "cpu"

    def test_default_device_is_cuda(self, monkeypatch):
        _, pc = _coo()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            pals.als_train(pc, 4, iterations=1)

    @pytest.mark.parametrize("env, param, want", [
        (None, False, False), (None, True, True), ("1", False, True), ("on", False, True),
        ("0", True, False), ("no", True, False), ("maybe", True, True),
    ])
    def test_resolve_shard_factors_env_rule_equals_jax(self, monkeypatch, env, param, want):
        if env is None:
            monkeypatch.delenv("PIO_TRAIN_SHARD_FACTORS", raising=False)
        else:
            monkeypatch.setenv("PIO_TRAIN_SHARD_FACTORS", env)
        assert pals.resolve_shard_factors(param) == jals.resolve_shard_factors(param) == want

    def test_predict_ratings_and_rmse_equal_jax(self):
        jc, pc = _coo(seed=13)
        rng = np.random.default_rng(14)
        U = rng.standard_normal((120, 6)).astype(np.float32)
        I = rng.standard_normal((80, 6)).astype(np.float32)
        want = np.asarray(jals.predict_ratings(jnp.asarray(U), jnp.asarray(I),
                                               jnp.asarray(pc.rows), jnp.asarray(pc.cols)))
        got = pals.predict_ratings(torch.from_numpy(U), torch.from_numpy(I), pc.rows, pc.cols)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        r_want = jals.rmse(jals.ALSFactors(jnp.asarray(U), jnp.asarray(I)), jc, chunk=700)
        r_got = pals.rmse(pals.ALSFactors(torch.from_numpy(U), torch.from_numpy(I)), pc,
                          chunk=700)
        assert abs(r_got - r_want) < 1e-5 * r_want


def test_tf32_setting_does_not_reach_the_f32_route(monkeypatch):
    """The f32 route computes in true f32 whatever the process set: the
    TF32 flag is off inside a half-step and restored after it."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    real = pals._cg_solve_batched

    def spy(*a, **k):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*a, **k)

    monkeypatch.setattr(pals, "_cg_solve_batched", spy)
    _, pc = _coo()
    pals.solve_half(torch.ones(80, 4), pals.ladder_rows(pc), 4, 0.1)
    assert seen and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32 is True

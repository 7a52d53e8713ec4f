"""Each frozen plain reference agrees with predictionio_tpu_torch at a tiny
size on the CPU; the references import nothing of the port, of JAX or of
the JAX package; the import check compares whole top-level names."""

from __future__ import annotations

import ast
import math

import bench_tiny
import numpy as np
import pytest
import torch

from benchmark.harness import guard
from benchmark.harness.manifest import BENCH_DIR
from benchmark.inputs import als as als_inputs
from benchmark.inputs import seqrec as seqrec_inputs
from benchmark.reference import als as als_ref
from benchmark.reference import lowp
from benchmark.reference import seqrec as seqrec_ref


def _cfg(dtype: str) -> dict:
    return dict(bench_tiny.tiny_cell(bench_tiny.SERVE).config, dtype=dtype)


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_seqrec_reference_matches_the_port_in_f32(seed):
    from predictionio_tpu_torch.models import seqrec

    cfg = _cfg("float32")
    w = seqrec_inputs.make_weights(cfg, seed, torch.device("cpu"))
    model = seqrec.SeqRec.from_state(
        seqrec.SeqRecConfig(vocab=cfg["vocab"], max_len=cfg["max_len"], d_model=cfg["d_model"],
                            n_heads=cfg["n_heads"], n_layers=cfg["n_layers"],
                            mlp_mult=cfg["mlp_mult"], dtype=torch.float32), w, "cpu")
    rng = np.random.default_rng(seed)
    for L in (1, 7, cfg["max_len"]):
        hist = rng.integers(1, cfg["vocab"], size=L)
        padded = np.zeros((1, cfg["max_len"]), np.int64)
        padded[0, :L] = hist
        mask = np.zeros((1, cfg["vocab"]), np.float32)
        mask[0, 0] = -1e30
        mask[0, hist] = -1e30
        vals, ids = seqrec.predict_topk_batch(model, torch.from_numpy(padded), 10,
                                              torch.from_numpy(mask))
        ref = seqrec_ref.scores(w, cfg, hist)
        torch.testing.assert_close(vals[0], ref[ids[0]], atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(vals[0], torch.sort(ref, descending=True).values[:10],
                                   atol=2e-4, rtol=2e-4)


def test_seqrec_fp8_rounding_moves_the_scores():
    cfg = _cfg("float32")
    w = seqrec_inputs.make_weights(cfg, 1, torch.device("cpu"))
    hist = np.arange(1, 40)
    exact = seqrec_ref.scores(w, cfg, hist)
    low = seqrec_ref.scores(w, cfg, hist, rounding=lowp.fp8)
    finite = torch.isfinite(exact)
    assert (low[finite] - exact[finite]).abs().max() > 0.05
    assert torch.isinf(low[0]) and torch.isinf(low[5])


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_als_reference_matches_the_port_exact_path(seed):
    from predictionio_tpu_torch.ops.als import RatingsCOO, als_train, init_item_factors

    cell = bench_tiny.tiny_cell(bench_tiny.TRAIN)
    cfg = cell.config
    rows, cols, vals = als_inputs.make_ratings(cell.traffic, cfg, seed)
    coo = RatingsCOO(rows=rows, cols=cols, vals=vals, num_rows=cfg["users"],
                     num_cols=cfg["items"])
    item_seed = als_inputs.item_seed(seed)
    torch.testing.assert_close(als_ref.starting_items(cfg["items"], cfg["rank"], item_seed),
                               init_item_factors(cfg["items"], cfg["rank"], item_seed))
    got = als_train(coo, rank=cfg["rank"], iterations=3, lam=cfg["lambda"], seed=item_seed,
                    matmul_dtype="float32", solver="cholesky", device="cpu")
    u, i = als_ref.train(rows, cols, vals, cfg["users"], cfg["items"],
                         als_ref.starting_items(cfg["items"], cfg["rank"], item_seed), 3,
                         cfg["lambda"], torch.device("cpu"))
    assert als_ref.worst_row_gap(got.user, u) < 1e-4
    assert als_ref.worst_row_gap(got.item, i) < 1e-4


def test_worst_row_gap_by_hand():
    ref = torch.tensor([[3.0, 4.0], [0.0, 0.0], [6.0, 8.0]])      # norms 5, 0, 10 (median 5)
    prog = ref + torch.tensor([[0.0, 0.5], [1.0, 0.0], [0.0, 0.0]])
    assert math.isclose(als_ref.worst_row_gap(prog, ref), 1.0 / 5.0)


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_references_import_only_torch_numpy_and_the_benchmark():
    for path in sorted((BENCH_DIR / "reference").glob("*.py")):
        assert _imports(path) <= {"__future__", "math", "typing", "numpy", "torch",
                                  "benchmark"}, path
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module:
                assert node.module.startswith(("benchmark.reference", "__future__", "typing",
                                               "numpy", "torch")), (path, node.module)


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in sorted(BENCH_DIR.rglob("*.py")):
        assert not (_imports(path) & guard.FORBIDDEN), path


@pytest.mark.parametrize("modules,found", [
    ({"predictionio_tpu_torch", "predictionio_tpu_torch.ops.als"}, []),
    ({"predictionio_tpu.ops.als"}, ["predictionio_tpu"]),
    ({"predictionio_tpu"}, ["predictionio_tpu"]),
    ({"jax.numpy", "numpy"}, ["jax"]),
    ({"jaxlib.xla_client", "flax.linen"}, ["flax", "jaxlib"]),
    ({"jaxtyping", "predictionio_tpu_torchx", "flaxen"}, []),
])
def test_import_check_compares_whole_top_level_names(modules, found):
    assert guard.forbidden_loaded(modules) == found


def test_the_port_loads_no_jax_and_a_loaded_jax_package_is_refused(monkeypatch):
    import sys
    import types

    import predictionio_tpu_torch.templates.recommendation  # noqa: F401
    import predictionio_tpu_torch.templates.sessionrec  # noqa: F401

    guard.check_no_jax()
    monkeypatch.setitem(sys.modules, "predictionio_tpu", types.ModuleType("predictionio_tpu"))
    with pytest.raises(guard.ForbiddenImport):
        guard.check_no_jax()

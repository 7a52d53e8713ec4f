"""The general generator is deterministic by seed and draws in range;
the roofline and FLOP arithmetic matches counts worked by hand."""

from __future__ import annotations

import math

import bench_tiny
import numpy as np
import pytest

from benchmark.harness import traffic as tr
from benchmark.inputs import als as als_inputs
from benchmark.inputs import seqrec as seqrec_inputs
from benchmark.roofline import attention, seqrec
from benchmark.roofline.peaks import DEFAULT_KIND, peaks_for

BIG_SEED = 2**31 + 12345


@pytest.mark.parametrize("name", [bench_tiny.SERVE, bench_tiny.TRAIN])
@pytest.mark.parametrize("seed", [0, BIG_SEED, 2**40 + 3])
def test_inputs_are_deterministic_by_seed(name, seed):
    cell = bench_tiny.tiny_cell(name)
    if cell.config["family"] == "seqrec":
        a = seqrec_inputs.make_histories(cell.traffic, cell.config, seed)
        b = seqrec_inputs.make_histories(cell.traffic, cell.config, seed)
        c = seqrec_inputs.make_histories(cell.traffic, cell.config, seed + 1)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert not all(len(x) == len(y) and np.array_equal(x, y) for x, y in zip(a, c))
        env = {**cell.config, "users": cell.traffic["users"]}
        s1 = tr.batches(cell.traffic["queries"], env, tr.rng(seed, "queries"))
        s2 = tr.batches(cell.traffic["queries"], env, tr.rng(seed, "queries"))
        assert all(np.array_equal(next(s1), next(s2)) for _ in range(5))
        w1 = seqrec_inputs.make_weights(cell.config, seed, bench_tiny.torch.device("cpu"))
        w2 = seqrec_inputs.make_weights(cell.config, seed, bench_tiny.torch.device("cpu"))
        assert all(bench_tiny.torch.equal(w1[k], w2[k]) for k in w1)
    else:
        a = als_inputs.make_ratings(cell.traffic, cell.config, seed)
        b = als_inputs.make_ratings(cell.traffic, cell.config, seed)
        c = als_inputs.make_ratings(cell.traffic, cell.config, seed + 1)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert not np.array_equal(a[0], c[0])


def test_full_size_draws_stay_in_range():
    serve = bench_tiny.load_cell(bench_tiny.SERVE)
    cfg, mix = serve.config, serve.traffic
    hist = tr.sequences(mix["history"], 2000, cfg, tr.rng(BIG_SEED, "data"))
    lengths = np.asarray([len(h) for h in hist])
    assert lengths.min() >= 16 and lengths.max() <= cfg["max_len"]
    flat = np.concatenate(hist)
    assert flat.min() >= 1 and flat.max() <= cfg["vocab"] - 1
    train = bench_tiny.load_cell(bench_tiny.TRAIN)
    spec = tr.resolve(train.traffic["ratings"], train.config)
    rows = tr.draw(spec["rows"], 100_000, tr.rng(BIG_SEED, "data"))
    vals = tr.draw(spec["values"], 100_000, tr.rng(BIG_SEED, "data"))
    assert rows.min() >= 0 and rows.max() < train.config["users"]
    assert set(np.unique(vals)) == {x / 2 for x in range(1, 11)}


@pytest.mark.parametrize("dist", [
    {"dist": "log_uniform_int", "low": 16, "high": 2048},
    {"dist": "power_int", "n": 1000, "exponent": 1.8},
    {"dist": "uniform_int", "low": 3, "high": 9}])
def test_stratified_draws_give_every_seed_the_same_multiset(dist):
    spec = dict(dist, stratified=True)
    a = tr.draw(spec, 5000, tr.rng(1, "data"))
    b = tr.draw(spec, 5000, tr.rng(BIG_SEED, "data"))
    assert not np.array_equal(a, b)
    assert np.array_equal(np.sort(a), np.sort(b))


def test_shuffled_cycle_visits_every_key_once_a_cycle():
    stream = tr.batches({"batch": 6, "keys": {"dist": "shuffled_cycle", "low": 0, "high": 8}},
                        {}, tr.rng(3, "queries"))
    keys = np.concatenate([next(stream) for _ in range(6)])      # 36 keys = 4 cycles of 9
    for c in range(4):
        assert sorted(keys[9 * c:9 * c + 9]) == list(range(9))


def test_distributions():
    g = tr.rng(1, "data")
    u = tr.draw({"dist": "uniform_int", "low": 3, "high": 5, "scale": 0.5}, 5000, g)
    assert set(np.unique(u)) == {1.5, 2.0, 2.5}
    lu = tr.draw({"dist": "log_uniform_int", "low": 16, "high": 2048}, 5000, g)
    assert lu.min() >= 16 and lu.max() <= 2048 and np.median(lu) < 400
    p = tr.draw({"dist": "power_int", "n": 100, "exponent": 1.8}, 5000, g)
    assert p.min() >= 0 and p.max() <= 99 and np.median(p) < 50
    with pytest.raises(ValueError):
        tr.draw({"dist": "nope"}, 1, g)


def test_causal_pairs_by_hand():
    # a row of L real items: L(L+1)/2 pairs among its real positions;
    # padded query rows and lengths past S count nothing
    assert attention.causal_pairs(4, [2]) == 2 + 1
    assert attention.causal_pairs(4, [4]) == 4 + 3 + 2 + 1
    assert attention.causal_pairs(4, [0, 1, 9]) == 0 + 1 + 10


def test_attention_launch_and_bound_by_hand():
    flops, nbytes = attention.attention_launch(S=4, heads=2, head_dim=8, lengths=[2, 4])
    assert flops == 4 * 8 * 2 * (3 + 10)
    # q, k, v, o of the 6 real positions in bf16, and their 6 f32 mask entries
    assert nbytes == 4 * 6 * 2 * 8 * 2 + 4 * 6
    peaks = {"bf16_flops": 1e3, "hbm_bytes": 1e6}
    t, by = attention.bound_s(4, 2, 8, [2, 4], peaks)
    assert by == "operations" and t == pytest.approx(flops / 1e3)
    t, by = attention.bound_s(4, 2, 8, [2, 4], {"bf16_flops": 1e12, "hbm_bytes": 1e3})
    assert by == "bytes" and t == pytest.approx(nbytes / 1e3)


def test_padding_adds_no_work_to_the_bound():
    # the same real rows padded to 2,048 or to 64 need the same least time
    peaks = {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}
    assert attention.bound_s(2048, 4, 64, [16, 40], peaks) == \
        attention.bound_s(64, 4, 64, [16, 40], peaks)


def test_seqrec_flops_by_hand():
    cfg = {"d_model": 2, "vocab": 5, "mlp_mult": 4, "max_len": 3, "n_layers": 2}
    # L = 2: per layer 2 tokens × (8·4 + 4·2·8) + 4·2·(2·3/2) = 2·96 + 24 = 216
    assert seqrec.query_forward_flops(cfg, 2) == 2 * 216 + 2 * 2 * 5
    # capped at max_len
    assert seqrec.query_forward_flops(cfg, 9) == seqrec.query_forward_flops(cfg, 3)
    assert seqrec.batch_forward_flops(cfg, [2, 2]) == 2 * seqrec.query_forward_flops(cfg, 2)


def test_peaks():
    p = peaks_for(DEFAULT_KIND)
    assert p["bf16_flops"] == 989e12 and p["hbm_bytes"] == 3.35e12
    with pytest.raises(KeyError):
        peaks_for("some other card")
    assert math.isclose(peaks_for("NVIDIA H100 PCIe")["bf16_flops"], 989e12)


class _Ev:
    def __init__(self, name, device, s, e):
        self._n, self._d, self._s, self._e = name, device, s, e

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


def test_trace_reduction_by_hand():
    from torch.autograd import DeviceType

    from benchmark.harness.trace import reduce_events

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        _Ev("bench.window", cpu, 0, 1_000_000),
        _Ev("bench.query_batch", cpu, 0, 900_000),
        _Ev("aten::stack", cpu, 100_000, 400_000),
        _Ev("aten::copy_", cpu, 150_000, 200_000),
        _Ev("bench.query_batch", gpu, 0, 900_000),          # a mirrored annotation
        _Ev("kernel_a", gpu, 10_000, 100_000),
        _Ev("kernel_b", gpu, 50_000, 120_000),               # overlaps kernel_a
        _Ev("Memcpy HtoD", gpu, 500_000, 510_000),
        _Ev("kernel_a", gpu, 515_000, 600_000),
        _Ev("kernel_c", gpu, 990_000, 1_200_000),            # runs past the window
    ]
    t = reduce_events(events)
    assert t.window_s == 1e-3
    busy_ns = (120_000 - 10_000) + 10_000 + 85_000 + 10_000
    assert t.busy_s == pytest.approx(busy_ns / 1e9)
    assert t.launches == 4
    assert t.device_ops["kernel_a"] == pytest.approx((90_000 + 85_000) / 1e9)
    # gaps: 0-10us (short), 120-500us (mid 310us: in aten::stack, copy_ closed),
    # 510-515us (short), 600-990us (mid 795us: the span, no op)
    assert t.idle_gaps["bench.query_batch: aten::stack"] == pytest.approx(380_000 / 1e9)
    assert t.idle_gaps["bench.query_batch: python"] == pytest.approx(390_000 / 1e9)
    assert t.idle_gaps["gaps under 20 us"] == pytest.approx(15_000 / 1e9)
    assert t.device_seconds(lambda n: n == "kernel_c") == pytest.approx(10_000 / 1e9)

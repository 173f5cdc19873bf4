"""Rates, percentiles and the trace arithmetic, on synthetic timestamps."""
import statistics

import pytest

from harness import spec, stats
from harness.record import Run
from harness.trace import (WINDOW, Trace, busy_ns, device_ops, idle_gaps,
                           kernel_ns, merged)


def test_quantile_matches_linear_interpolation():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.quantile(xs, 0.5) == 3.0
    assert stats.quantile(xs, 0.95) == pytest.approx(4.8)
    assert stats.quantile(list(range(101)), 0.95) == 95.0
    assert stats.quantile([7.0], 0.95) == 7.0
    assert stats.median([1.0, 2.0, 3.0, 10.0]) == statistics.median(
        [1.0, 2.0, 3.0, 10.0])
    with pytest.raises(ValueError):
        stats.quantile([], 0.5)


def test_rate_and_gaps():
    assert stats.rate(30, 10.0, 12.0) == 15.0
    with pytest.raises(ValueError):
        stats.rate(1, 2.0, 2.0)
    assert stats.gaps([1.0, 1.5, 3.0]) == [0.5, 1.5]


def serve_run(**kw):
    waves = []
    for i in range(20):                    # one wave every 0.5 s
        send = 100.0 + 0.5 * i
        waves.append({"send": send, "first": send + 0.1 + 0.001 * i,
                      "done": send + 0.4,
                      "decode_entries": [send + 0.1, send + 0.2,
                                         send + 0.32],
                      "prefill_s": 0.09, "profiled": i == 3,
                      "lengths": [1000, 2000],
                      "out": [[1, 2, 3, 4], [5, 6, 7, 8]]})
    cfg = spec.cell("dsmoe-prefill-2k").config
    return Run(kind="serve", config=cfg, traffic={}, setup_s=12.5,
               window=(100.0, 110.0), peak_bytes=3 * 2 ** 30, waves=waves,
               **kw)


def read(name, run):
    return spec.reader(name).read(run)


def test_serving_readers():
    run = serve_run()
    assert read("output_tokens_per_s", run) == pytest.approx(160 / 10.0)
    ttft = sorted(0.1 + 0.001 * i for i in range(20) for _ in range(2))
    assert read("ttft_p95_ms", run) == pytest.approx(
        1e3 * stats.quantile(ttft, 0.95))
    assert read("setup_s", run) == 12.5
    assert read("peak_mem_gib", run) == 3.0
    assert read("prefill_wave_ms", run) == pytest.approx(90.0)
    assert read("decode_step_ms", run) == pytest.approx(110.0)
    assert read("train_tokens_per_s", run) is None
    from harness.flops import PEAK_BF16, prefill_flops
    assert read("mfu.prefill", run) == pytest.approx(
        100 * prefill_flops(run.config, [1000, 2000]) / 0.09 / PEAK_BF16)
    # no trace: the device's readers find nothing and say nothing
    for name in ("idle_share.serve", "moe_gemm_roofline",
                 "rwkv6_scan_roofline"):
        assert read(name, run) is None


def test_training_readers():
    steps = [{"start": 10.0 + i, "end": 11.0 + i, "tokens": 8192,
              "loss_finite": True, "profiled": i == 1} for i in range(5)]
    cfg = spec.cell("rwkv6-train-4k").config
    run = Run(kind="train", config=cfg, traffic={"batch": 2, "seq": 4096},
              setup_s=30.0, window=(10.0, 15.0), peak_bytes=0, steps=steps)
    assert read("train_tokens_per_s", run) == pytest.approx(8192.0)
    from harness.flops import PEAK_BF16, train_flops
    assert read("mfu.train", run) == pytest.approx(
        100 * train_flops(cfg, 2, 4096) / PEAK_BF16)
    assert read("peak_mem_gib", run) is None
    assert read("output_tokens_per_s", run) is None


def synthetic_trace():
    ms = 1_000_000
    device = [("moe_gemm_kernel_mma<64>", 1 * ms, 3 * ms),
              ("elementwise", 2 * ms, 4 * ms),           # overlaps
              ("moe_gemm_kernel_mma<8>", 6 * ms, 7 * ms),
              ("flash", 12 * ms, 13 * ms)]
    host = [("aten::mm", 0, 5 * ms), ("aten::item", 4 * ms, 6 * ms),
            ("cudaStreamSynchronize", 8 * ms, 11 * ms)]
    spans = [(WINDOW, 0, 10 * ms), ("chipbench.prefill", 0, 5 * ms + ms // 2),
             ("chipbench.decode", 6 * ms, 9 * ms)]
    return Trace(device, host, spans)


def test_trace_arithmetic():
    t = synthetic_trace()
    ms = 1_000_000
    assert merged([(1, 3), (2, 4), (6, 7), (9, 20)], 0, 10) == \
        [(1, 4), (6, 7), (9, 10)]
    assert busy_ns(t, *t.window()) == 4 * ms
    assert kernel_ns(t, "moe_gemm", "chipbench.prefill") == (2 * ms, 1)
    assert kernel_ns(t, "moe_gemm", "chipbench.decode") == (1 * ms, 1)
    assert kernel_ns(t, "rwkv6_scan", "chipbench.prefill") == (0, 0)
    ops = device_ops(t)
    assert ops[0][0] in ("moe_gemm_kernel_mma<64>", "elementwise")
    assert ops[0][1] == pytest.approx(0.002)
    # idle [0, 1) under aten::mm, [4, 6) under aten::item, [7, 10) under
    # the synchronise (inside the decode span)
    assert dict(idle_gaps(t)) == pytest.approx(
        {"aten::mm": 0.001, "aten::item": 0.002,
         "cudaStreamSynchronize": 0.003})


def test_traced_readers():
    t = synthetic_trace()
    run = serve_run(trace=t)
    assert read("idle_share.serve", run) == pytest.approx(60.0)
    reader = spec.reader("moe_gemm_roofline")
    # the one profiled wave's real tokens, 1000 + 2000, not its padding
    want = 100 * reader.least_seconds(run.config, 3000) / 0.002
    run.traffic = {"batch_slots": 16, "prompt_len": 2048}
    assert read("moe_gemm_roofline", run) == pytest.approx(want)
    assert read("rwkv6_scan_roofline", run) is None
    # no kernel of its name in the prefill spans: the reader says nothing
    run.trace = Trace([("other", 1, 2)], [], t.spans)
    assert read("moe_gemm_roofline", run) is None

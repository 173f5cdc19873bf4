"""mla_attention_roofline's work count against a hand count, and its
reading of a synthetic trace: rank 0's share of the real prompts' work,
nothing where no kernel of its name ran or the mixer is not MLA."""
import pytest

from harness import spec
from harness.trace import Trace
from test_chipbench_stats import serve_run, synthetic_trace

DSV2 = spec.cell("dsv2-tp4-prefill").config
READER = spec.reader("mla_attention_roofline")


def test_mla_attention_work_by_hand():
    f, b = READER.work(DSV2, [4096] * 8)
    pairs = 8 * 4096 * 4097 // 2
    assert f == 30 * 2 * pairs * 128 * (192 + 128)
    assert b == 30 * 2 * 8 * 4096 * (128 * (192 + 128 + 2 * 128) + 64)
    # a card's layer at the padded shape (32 of 128 heads): 1.38 TFLOP,
    # FLOP-bound at 989 TFLOP/s
    assert f / 30 / 4 == pytest.approx(1.376e12, rel=1e-3)
    assert READER.least_seconds(DSV2, [4096] * 8) == f / 989e12
    # real lengths only, each prompt its own triangle
    f, b = READER.work(DSV2, [1000, 3000])
    assert f == 30 * 2 * (1000 * 1001 // 2 + 3000 * 3001 // 2) * 128 * 320
    assert b == 30 * 2 * 4000 * (128 * 576 + 64)


def test_reads_rank_0_s_kernels_against_its_share_of_the_work():
    run = serve_run(trace=synthetic_trace())
    run.config = DSV2
    # no kernel of its name in the prefill spans: the reader says nothing,
    # as on a tree whose MLA prefill has no kernel
    assert READER.read(run) is None
    ms = 1_000_000
    run.trace.device.append(("mla_attention_kernel_mma<128, 64, 128>",
                             1 * ms, 5 * ms))
    want = 100 * READER.least_seconds(DSV2, [1000, 2000]) / 4 / 0.004
    assert READER.read(run) == pytest.approx(want)
    # outside the prefill spans it is not counted
    run.trace = Trace([("mla_attention_kernel_mma<128, 64, 128>", 6 * ms,
                        7 * ms)], [], run.trace.spans)
    assert READER.read(run) is None
    # another mixer reads nothing, whatever ran
    run = serve_run(trace=synthetic_trace())
    run.trace.device.append(("mla_attention_kernel_mma<128, 64, 128>",
                             1 * ms, 5 * ms))
    assert READER.read(run) is None

"""moe_slot_fill_share (`metrics/moe_slot_fill_share.py`) as the harness
reads it: the rows kept, (`moe.rows_routed` - `moe.rows_dropped`), over
the slots the capacity path laid out (`moe.slots`), through the program's
device tracer; silent wherever one of them is missing."""
import pytest
from test_chipbench_phases import phase_trace
from test_chipbench_stats import serve_run

from harness import spec


@pytest.fixture
def tracer():
    from repro_torch.obs.realtime import DEVICE_TRACER
    DEVICE_TRACER.reset()
    yield DEVICE_TRACER
    DEVICE_TRACER.reset()


def test_slot_fill_reader(tracer):
    """Silent without the counters, with no capacity MoE (no `moe.slots`)
    and outside a traced serving run."""
    import torch
    run = serve_run(trace=phase_trace())
    reader = spec.reader("moe_slot_fill_share")
    assert reader.read(run) is None
    tracer.count("moe.rows_routed", 3000 * 6)
    tracer.count("moe.rows_dropped", torch.tensor(6000))
    # a program that counts rows but not slots: silent
    assert reader.read(run) is None
    tracer.count("moe.slots", 64 * 240)
    tracer.count("moe.slots", 64 * 240)
    assert reader.read(run) == pytest.approx(100 * 12000 / 30720)
    assert reader.read(serve_run()) is None


def test_slot_fill_reader_silent_without_the_device_channel(monkeypatch):
    from repro_torch.obs import realtime
    monkeypatch.delattr(realtime, "DEVICE_TRACER")
    assert spec.reader("moe_slot_fill_share").read(
        serve_run(trace=phase_trace())) is None

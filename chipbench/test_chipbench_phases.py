"""The program's phases and counters as the readers see them
(`harness/phases.py`): idle time inside spans on synthetic intervals, and
the counters through the program's device tracer."""
import pytest
from test_chipbench_stats import serve_run

from harness import spec
from harness.phases import idle_inside_ns, idle_share, program_counters
from harness.record import Run
from harness.trace import WINDOW, Trace, busy_ns

MS = 1_000_000
PHASES = ("serve.prefill", "serve.decode")


def phase_trace():
    """A window [0, 20) ms, the device busy [1, 4), [6, 7), [12, 13) and
    [16, 18); the driving thread in a prefill [-2, 9) (cut by the window's
    start) with an FFN span [5, 8) inside, then a read-back [9, 10), a
    decode [10, 14) and a decode [15, 22) (cut by its end)."""
    device = [("k", 1 * MS, 4 * MS), ("k", 6 * MS, 7 * MS),
              ("k", 12 * MS, 13 * MS), ("k", 16 * MS, 18 * MS)]
    host = [("serve.prefill", -2 * MS, 9 * MS),
            ("model.ffn", 5 * MS, 8 * MS), ("aten::mm", 6 * MS, 7 * MS),
            ("serve.readback", 9 * MS, 10 * MS),
            ("serve.decode", 10 * MS, 14 * MS),
            ("serve.decode", 15 * MS, 22 * MS)]
    return Trace(device, host, [(WINDOW, 0, 20 * MS)])


def test_idle_inside_spans():
    t = phase_trace()
    # prefill [0, 9) less busy [1, 4) and [6, 7): 5 ms
    assert idle_inside_ns(t, "serve.prefill") == 5 * MS
    # a span nested in another counts under its own name: [5, 8) less [6, 7)
    assert idle_inside_ns(t, "model.ffn") == 2 * MS
    assert idle_inside_ns(t, "serve.readback") == 1 * MS
    # decode [10, 14) and [15, 20), less [12, 13) and [16, 18)
    assert idle_inside_ns(t, "serve.decode") == 6 * MS
    assert idle_share(t, "serve.decode") == pytest.approx(30.0)
    assert idle_inside_ns(t, "train.forward") is None
    assert idle_share(t, "train.forward") is None


def test_same_name_spans_counted_once():
    t = phase_trace()
    t.host.append(("serve.prefill", 2 * MS, 3 * MS))    # nested in itself
    assert idle_inside_ns(t, "serve.prefill") == 5 * MS


def test_phases_and_outside_make_the_idle_share():
    t = phase_trace()
    lo, hi = t.window()
    idle = 100.0 * (1.0 - busy_ns(t, lo, hi) / (hi - lo))
    phases = [idle_share(t, n) for n in PHASES + ("serve.readback",)]
    # outside every phase: [14, 15) and nothing else
    outside = 100.0 * 1 * MS / (hi - lo)
    assert sum(phases) + outside == pytest.approx(idle)
    assert sum(phases) <= idle


@pytest.mark.parametrize("name,span", [
    ("idle_share.prefill", "serve.prefill"),
    ("idle_share.decode", "serve.decode")])
def test_serving_phase_readers(name, span):
    t = phase_trace()
    run = serve_run(trace=t)
    assert spec.reader(name).read(run) == pytest.approx(idle_share(t, span))
    # the parent program's trace holds no such span: silent
    run.trace = Trace(t.device, [], t.spans)
    assert spec.reader(name).read(run) is None
    assert spec.reader(name).read(serve_run()) is None


@pytest.mark.parametrize("phase", ["forward", "backward", "optimizer"])
def test_training_phase_readers(phase):
    t = phase_trace()
    t.host = [(n.replace("serve.prefill", "train." + phase), s, e)
              for n, s, e in t.host]
    run = Run(kind="train", config={}, traffic={}, setup_s=1.0,
              window=(0.0, 1.0), peak_bytes=0, trace=t)
    reader = spec.reader("idle_share." + phase)
    assert reader.read(run) == pytest.approx(5 * MS / (20 * MS) * 100)
    assert reader.read(serve_run(trace=t)) is None


@pytest.fixture
def tracer():
    from repro_torch.obs.realtime import DEVICE_TRACER
    DEVICE_TRACER.reset()
    yield DEVICE_TRACER
    DEVICE_TRACER.reset()


def test_counter_readers(tracer):
    import torch
    run = serve_run(trace=phase_trace())
    assert spec.reader("prefill_pad_share").read(run) is None
    assert spec.reader("moe_drop_share").read(run) is None
    tracer.count("serve.prefill_positions", 2 * 2048)
    tracer.count("serve.prefill_tokens", 1000 + 2000)
    tracer.count("moe.rows_routed", 3000 * 6)
    tracer.count("moe.rows_dropped", torch.tensor(4500))
    tracer.count("moe.rows_dropped", lambda: torch.tensor([True] * 1500)
                 .sum())
    assert program_counters()["moe.rows_dropped"] == 6000.0
    assert spec.reader("prefill_pad_share").read(run) == pytest.approx(
        100 * (1 - 3000 / 4096))
    assert spec.reader("moe_drop_share").read(run) == pytest.approx(
        100 * 6000 / 18000)
    # not a traced run: silent whatever the counters hold
    assert spec.reader("moe_drop_share").read(serve_run()) is None


def test_counters_of_a_program_without_the_device_channel(monkeypatch):
    from repro_torch.obs import realtime
    monkeypatch.delattr(realtime, "DEVICE_TRACER")
    assert program_counters() == {}
    assert spec.reader("prefill_pad_share").read(
        serve_run(trace=phase_trace())) is None

"""The DeepSeek-V2 cell over four cards (`dsv2-tp4-prefill`) on the CPU:
its manifest entry and configuration against the published config, its
plain reference (`reference/mla_moe_decoder.py`) drawn piece by piece and
whole, the program's served logits at a small copy of the configuration
against the reference's on one rank and on two gloo ranks, and the two
collectives metrics on synthetic traces and counters."""
import copy
import json
import time
from pathlib import Path

import pytest
import torch
from test_chipbench_phases import phase_trace
from test_chipbench_stats import serve_run

from harness import flops, ranks, serve, spec
from harness.trace import WINDOW, Trace
from harness.weights import make_weights, model_weights, piece
from reference import common
from reference import mla_moe_decoder as ref

ROOT = Path(__file__).resolve().parents[1]
CELL = "dsv2-tp4-prefill"
CONFIG = spec.cell(CELL).config
SEED = 2 ** 31 + 301
MS = 1_000_000
# 4 heads, q_lora, 4 groups of 4 experts (2 kept, top 3), YaRN as
# published; d_model 128 and a 512-row head, as the other small cells
SMALL = dict(n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
             vocab=512,
             mla={"q_lora": 48, "kv_lora": 32, "qk_nope": 32, "qk_rope": 16,
                  "v_dim": 32},
             moe={"n_routed": 16, "top_k": 3, "n_shared": 1,
                  "d_ff_expert": 64, "first_dense_layers": 1,
                  "d_ff_dense": 256, "n_group": 4, "topk_group": 2,
                  "norm_topk": False, "routed_scaling": 16.0})
SMALL_TRAFFIC = dict(clients=4, batch_slots=4, prompt_len=64, prompt_min=16,
                     length_median=40, length_pool=16, warmup_waves=1,
                     trace_from=1, trace_waves=1, check_waves=2)


def small_cell(model=None, dtype=None):
    c = spec.cell(CELL)
    c.config.update(copy.deepcopy(SMALL))
    if dtype:
        c.config["dtype"] = dtype
    if model is None:
        c.config.pop("mesh")
        c.chips = 1
    else:
        c.config["mesh"] = {"data": 1, "model": model}
        c.chips = model
    c.traffic.update(SMALL_TRAFFIC)
    return c


def test_the_cell_asks_for_its_mesh_of_four_cards():
    cell = spec.cell(CELL)
    assert cell.chips == 4 == spec.mesh_size(cell.config)
    assert cell.config["mesh"] == {"data": 1, "model": 4}
    man = spec.manifest()
    assert [w["name"] for w in man["workloads"] if w["chips"] == 4] == [CELL]
    names = {m["name"] for m in cell.per_layer}
    assert {"nccl_share", "allreduce_bytes_per_position", "mfu.prefill",
            "moe_gemm_roofline"} <= names
    assert {m["name"] for m in cell.end_to_end} == {
        "setup_s", "peak_mem_gib", "output_tokens_per_s", "ttft_p95_ms"}


def test_the_file_keeps_every_published_width():
    """The program's keys agree with the published config.json's, which the
    file keeps as its source states them; depth alone is cut."""
    c, a, m = CONFIG, CONFIG["mla"], CONFIG["moe"]
    assert c["d_model"] == c["hidden_size"] == 5120
    assert c["n_heads"] == c["num_attention_heads"] == 128
    assert c["vocab"] == c["vocab_size"] == 102400
    assert (a["q_lora"], a["kv_lora"], a["qk_nope"], a["qk_rope"],
            a["v_dim"]) == (c["q_lora_rank"], c["kv_lora_rank"],
                            c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                            c["v_head_dim"])
    assert (m["n_routed"], m["top_k"], m["n_shared"], m["d_ff_expert"],
            m["d_ff_dense"], m["first_dense_layers"]) == (
        c["n_routed_experts"], c["num_experts_per_tok"],
        c["n_shared_experts"], c["moe_intermediate_size"],
        c["intermediate_size"], c["first_k_dense_replace"])
    assert (m["n_group"], m["topk_group"], m["norm_topk"],
            m["routed_scaling"]) == (c["n_group"], c["topk_group"],
                                     c["norm_topk_prob"],
                                     c["routed_scaling_factor"])
    assert c["reduced"] == ["n_layers"] and c["n_layers"] == 30
    assert c["published"] == {"n_layers": c["num_hidden_layers"]}
    arch = spec.arch_config(c)
    assert arch.rope_scaling == c["rope_scaling"]
    assert arch.rope_theta == c["rope_theta"]


def test_parameter_counts_match_the_program_layout():
    from repro_torch.models.module import count_params
    from repro_torch.models.zoo import active_params, build_param_specs
    arch = spec.arch_config(CONFIG)
    assert flops.total_params(CONFIG) == count_params(build_param_specs(arch))
    assert flops.active_params(CONFIG) == active_params(arch)
    # one MoE layer: 3.97e9 parameters, 1/4 of its experts a card
    D = 5120
    mla = D * 1536 + 1536 + 1536 * 128 * 192 + D * 576 + 512 + \
        2 * 512 * 128 * 128 + 128 * 128 * D
    moe = D * 160 + 160 * 3 * D * 1536 + 3 * D * 3072
    assert flops.total_params(CONFIG) == (
        mla + 3 * D * 12288 + 2 * D + 29 * (mla + moe + 2 * D)
        + 2 * 102400 * D + D)


def test_streamed_reference_equals_the_whole_one():
    """`serve_logits_by_leaf` drawing every piece itself, its rows and
    experts spread over two devices, against `serve_logits` over the whole
    tree put together from the same pieces (float32 sums in another order
    only: 1e-5)."""
    cell = small_cell(model=2)
    cfg = cell.config
    whole = model_weights(cfg, "cpu")
    tokens = torch.randint(1, 512, (3, 40), generator=torch.Generator()
                           .manual_seed(1))
    want = ref.serve_logits(cfg, whole, tokens, 36)
    got = ref.serve_logits_by_leaf(
        cfg, lambda path, dev, layer: piece(cfg, path, dev, layer), tokens,
        36, common.FLOAT32, ["cpu", "cpu"])
    assert got.shape == want.shape == (3, 5, 512)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    one = ref.serve_logits_by_leaf(
        cfg, lambda path, dev, layer: piece(cfg, path, dev, layer), tokens,
        36, common.FLOAT32, ["cpu"])
    assert torch.equal(one, want)


def test_control_is_far_from_the_reference():
    """The float8 control's chosen tokens lie well below the reference's
    best: what the cell's limit is held against."""
    cell = small_cell(dtype="float32")
    cfg = cell.config
    params = make_weights(ref.param_layout(cfg), 7, "cpu")
    tokens = torch.randint(1, 512, (4, 68), generator=torch.Generator()
                           .manual_seed(2))
    want = ref.serve_logits(cfg, params, tokens, 64)
    low = ref.serve_logits(cfg, params, tokens, 64, common.Precision("fp8"))
    assert float(serve.gaps(want, low.argmax(-1)).mean()) > 0.012


def _served(cell, params):
    """The engine's float32 logits of one wave (prefill, then each decode
    step) and the wave."""
    from repro_torch.models import zoo
    from repro_torch.serve.engine import Request, ServeEngine
    tr = cell.traffic
    engine = ServeEngine(spec.arch_config(cell.config),
                         common.as_float(params),
                         batch_slots=tr["batch_slots"],
                         max_len=tr["prompt_len"] + tr["new_tokens"],
                         prompt_len=tr["prompt_len"], device="cpu")
    prompts = serve.Feed(tr, cell.config["vocab"], 7).wave(tr["clients"])
    caught = []
    saved = zoo.prefill, zoo.decode_step

    def keep(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            caught.append(out[0].clone())
            return out
        return call
    zoo.prefill, zoo.decode_step = keep(saved[0]), keep(saved[1])
    try:
        reqs = [Request(prompt=p, max_new_tokens=tr["new_tokens"])
                for p in prompts]
        engine.serve(reqs)
    finally:
        zoo.prefill, zoo.decode_step = saved
    return torch.stack(caught, 1), {"prompts": prompts,
                                    "out": [r.out_tokens for r in reqs]}


def test_served_logits_match_the_reference():
    """The program's prefill and absorbed decode through the cache, in
    float32, against the reference's full forward pass: 2e-5 (float32 sums
    in other orders over 3 layers; MoE weights scaled 16)."""
    cell = small_cell(dtype="float32")
    params = make_weights(ref.param_layout(cell.config), 7, "cpu")
    got, wave = _served(cell, params)
    want = serve.reference_logits(cell, params, wave, ["cpu"],
                                  common.FLOAT32)
    assert got.shape == want.shape == (4, 4, 512)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    assert float(serve.gaps(want, torch.as_tensor(wave["out"])).max()) \
        < 1e-3


def served_in_float32(cell, seed, seconds, traced, device, t_start, mesh):
    from harness import weights
    from harness.cell_run import run_once
    weights.DTYPES = dict.fromkeys(weights.DTYPES, torch.float32)
    line, run = run_once(cell, seed, seconds, traced, device, t_start, mesh)
    return line and {"line": line, "out": [w["out"] for w in run.waves]}


def test_two_gloo_ranks_serve_the_reference_tokens():
    """The cell's own path over a mesh of two ranks (the harness's spawned
    ranks, each its blocks of the seeded weights, `ServeEngine(mesh=)`),
    traced: `correct` against the reference, and the collectives metrics
    read from rank 0's counters."""
    t0 = time.perf_counter()
    code, got = ranks.launch(small_cell(model=2, dtype="float32"), SEED, 1.0, True, t0,
                             device_type="cpu", body=served_in_float32,
                             limit_s=240)
    assert code == 0
    line = got["line"]
    json.dumps(line)
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["served_gap_mean"]["value"] < 1e-4
    assert line["failed"] == 0 and line["device"]["count"] == 2
    # two all-reduces a layer and the embedding's, float32 rows of 128
    per = line["metrics"]["allreduce_bytes_per_position"]["value"]
    assert 7 * 128 * 4 <= per < 7 * 128 * 4 * 1.1
    assert "nccl_share" not in line["metrics"]      # gloo runs no kernel


def test_nccl_share_on_a_synthetic_trace():
    """NCCL kernels inside the prefill spans over the busy time there:
    [1, 4) ms of compute, an all-reduce [4, 6) and another [8, 9) in a
    span [0, 10); one [12, 13) in a decode outside any prefill span."""
    device = [("gemm", 1 * MS, 4 * MS),
              ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL", 4 * MS, 6 * MS),
              ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL", 8 * MS, 9 * MS),
              ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL", 12 * MS,
               13 * MS)]
    spans = [(WINDOW, 0, 20 * MS), ("chipbench.prefill", 0, 10 * MS)]
    reader = spec.reader("nccl_share")
    run = serve_run(trace=Trace(device, [], spans))
    assert reader.read(run) == pytest.approx(100 * 3 / 6)
    # no NCCL kernel, no prefill span, no trace: silent
    assert reader.read(serve_run(trace=Trace(device[:1], [], spans))) is None
    assert reader.read(serve_run(trace=Trace(device, [], spans[:1]))) is None
    assert reader.read(serve_run()) is None


@pytest.fixture
def tracer():
    from repro_torch.obs.realtime import DEVICE_TRACER
    DEVICE_TRACER.reset()
    yield DEVICE_TRACER
    DEVICE_TRACER.reset()


def test_allreduce_bytes_per_position(tracer):
    run = serve_run(trace=phase_trace())
    reader = spec.reader("allreduce_bytes_per_position")
    assert reader.read(run) is None
    tracer.count("serve.prefill_positions", 8 * 4096)
    assert reader.read(run) is None             # one card: no all-reduce
    tracer.count("tp.allreduce_bytes", 61 * 8 * 4096 * 10240)
    tracer.count("tp.allreduces", 61)
    assert reader.read(run) == pytest.approx(61 * 10240)
    assert reader.read(serve_run()) is None

"""The port's dry run (`repro_torch.launch.dryrun`) on the CPU: twins of
`tests/test_dryrun.py` (llama3.2-3b at full width on an abstract (2, 4)
mesh: train_4k with its roofline and collectives, decode_32k, and the
long_500k skip), the remat ratio of llama3.2-3b's full-width, full-depth
train step, every config at reduced size through every shape, the skips
against the reference's, the memory report and the CLI.

The full-width twins cut llama3.2-3b to 2 of its 28 layers: at full depth
train_4k dispatches about 200k ops on fake tensors (a minute and a half
of host time), and every layer is alike.  The every-config test runs the
reduced configs at the shapes' kinds with short sequences (`SMALL`):
prefill_32k at full length unrolls 2048 attention block pairs a layer."""
import dataclasses
import json

import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES

from repro_torch.configs import ARCHS, SHAPES, reduce_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import zoo
from repro_torch.models.module import param_bytes
from repro_torch.sharding.rules import Mesh, local_specs, tree_shardings
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import TrainStepConfig, train_state_specs

ARCH = "llama3.2-3b"
SMALL = {"train_4k": ShapeConfig("train_4k", "train", 256, 8),
         "prefill_32k": ShapeConfig("prefill_32k", "prefill", 1024, 4),
         "decode_32k": ShapeConfig("decode_32k", "decode", 1024, 8),
         "long_500k": SHAPES["long_500k"]}


def _mesh(shape=(2, 4)):
    return Mesh.abstract(shape, ("data", "model"), device_type="cpu")


@pytest.fixture
def two_layers(monkeypatch):
    monkeypatch.setitem(ARCHS, ARCH,
                        dataclasses.replace(ARCHS[ARCH], n_layers=2))


def test_lower_cell_train_reports_roofline(two_layers):
    rec, rep = dryrun.lower_cell(ARCH, "train_4k", multi_pod=False,
                                 mesh=_mesh(), device="cpu")
    assert not rep.get("skipped") and not rep.get("failed")
    assert rep["mesh"] == "2x4" and rep["chips"] == 8
    r = rep["roofline"]
    assert r["t_compute_s"] > 0 and r["t_memory_s"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < r["useful_flops_ratio"] < 2.0
    assert r["collective_bytes"] > 0  # sharded step must communicate
    assert set(r["collective_breakdown"]) == {"all-gather", "all-reduce"}
    assert r["xla_flops"] == r["flops"]
    assert rep["compile_s"] == 0.0
    assert rep["memory"]["generated_code_size_bytes"] is None
    assert rec.log and all(kind in ("all-gather", "all-reduce")
                           for kind, *_ in rec.log)


def test_lower_cell_decode_and_skip(two_layers):
    _, rep = dryrun.lower_cell(ARCH, "decode_32k", multi_pod=False,
                               mesh=_mesh(), device="cpu")
    assert rep["kind"] == "decode" and not rep.get("failed")
    assert rep["roofline"]["flops"] > 0
    # full-attention arch skips long_500k with a documented reason
    rec, rep2 = dryrun.lower_cell(ARCH, "long_500k", multi_pod=False,
                                  mesh=_mesh(), device="cpu")
    assert rec is None
    assert rep2["skipped"] and "sub-quadratic" in rep2["why"]


def test_memory_report_is_rank0s_blocks(two_layers):
    """Argument bytes: this rank's blocks of the parameters and the AdamW
    state plus the global batch; the step updates in place, so its
    outputs are those blocks and the metrics' scalars."""
    mesh = _mesh()
    cfg, shape = ARCHS[ARCH], SHAPES["train_4k"]
    _, rep = dryrun.lower_cell(ARCH, "train_4k", multi_pod=False,
                               mesh=mesh, device="cpu")
    pspecs = zoo.build_param_specs(cfg)
    sspecs = train_state_specs(pspecs, TrainStepConfig(opt=AdamWConfig()))
    blocks = sum(param_bytes(local_specs(s, tree_shardings(s, mesh)))
                 for s in (pspecs, sspecs))
    batch = 2 * shape.global_batch * shape.seq_len * 4   # int32 tokens, labels
    mem = rep["memory"]
    assert mem["argument_size_bytes"] == blocks + batch
    assert blocks < mem["output_size_bytes"] < blocks + 64
    assert mem["temp_size_bytes"] > 0


def test_full_width_step_counts_remat_recompute(monkeypatch):
    """llama3.2-3b at full width and depth, B 8 x S 1024 on (1, 1): the
    recorder's FLOPs equal FlopCounterMode's, and the analytic 6ND-style
    model FLOPs are 0.751 of them (full remat runs every layer's forward
    twice, and the chunked loss its head product once more)."""
    shape = ShapeConfig("b8s1024", "train", 1024, 8)
    monkeypatch.setitem(SHAPES, shape.name, shape)
    _, rep = dryrun.lower_cell(ARCH, shape.name, multi_pod=False,
                               mesh=_mesh((1, 1)), device="cpu")
    r = rep["roofline"]
    assert r["xla_flops"] == r["flops"]
    assert r["model_flops"] == zoo.model_flops(ARCHS[ARCH], shape)
    assert r["useful_flops_ratio"] == pytest.approx(0.751, abs=5e-4)
    assert r["collective_bytes"] == 0.0


def test_flop_counter_counts_bmm_with_out_dtype():
    """The card's bf16 products with float32 sums (`bmm.dtype`, which a
    cell on "cuda" dispatches through `layers.matmul_f32`) count as `bmm`
    does; torch's own formula raises on them."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        a = torch.empty(3, 4, 8, dtype=torch.bfloat16)
        b = torch.empty(3, 8, 5, dtype=torch.bfloat16)
        counter = dryrun.flop_counter()
        with counter:
            torch.bmm(a, b, out_dtype=torch.float32)
            torch.bmm(a, b)
    assert counter.get_total_flops() == 2 * (2 * 3 * 4 * 8 * 5)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_config_runs_every_shape(monkeypatch, arch):
    """Each config, reduced, through every shape's kind on an abstract
    (2, 4) mesh: no failure, every supported cell counted (the MoE
    families included: their slot counts have a static shape), and the
    skips the config's `supports_shape`."""
    monkeypatch.setitem(ARCHS, arch, reduce_config(ARCHS[arch]))
    for name, shape in SMALL.items():
        monkeypatch.setitem(SHAPES, name, shape)
    for name in SMALL:
        rec, rep = dryrun.lower_cell(arch, name, multi_pod=False,
                                     mesh=_mesh(), device="cpu")
        ok, _ = ARCHS[arch].supports_shape(SHAPES[name])
        assert rep.get("skipped", False) is (not ok), (name, rep)
        if not ok:
            continue
        r = rep["roofline"]
        assert r["flops"] > 0 and r["xla_flops"] == r["flops"], name
        assert r["hbm_bytes"] > r["attn_tile_bytes"] >= 0, name
        assert r["collective_bytes"] > 0, name
        assert rep["memory"]["argument_size_bytes"] > 0, name


def test_skips_are_the_references():
    """A cell is skipped exactly where the reference's dry run skips it
    (long_500k for the full-attention configs), before any run."""
    skipped = set()
    for arch in ARCHS:
        for shape in SHAPES:
            ok, why = REF_ARCHS[arch].supports_shape(REF_SHAPES[shape])
            if not ok:
                rec, rep = dryrun.lower_cell(arch, shape, multi_pod=False,
                                             device="cpu")
                assert rec is None and rep["why"] == why
                skipped.add((arch, shape))
            else:
                assert ARCHS[arch].supports_shape(SHAPES[shape])[0]
    assert {s for _, s in skipped} == {"long_500k"}
    assert len(skipped) == 8


def test_cli_writes_reports_and_fails_on_a_failure(monkeypatch, tmp_path,
                                                   capsys):
    """The reference's CLI lines and exit: `[ OK ]` and `[SKIP]` cells and
    one JSON report each; a cell that raises prints `[FAIL]` and the run
    exits 1."""
    monkeypatch.setitem(ARCHS, ARCH, reduce_config(ARCHS[ARCH]))
    monkeypatch.setitem(ARCHS, "broken", dataclasses.replace(
        reduce_config(ARCHS[ARCH]), mixer="none"))
    for name, shape in SMALL.items():
        monkeypatch.setitem(SHAPES, name, shape)
    dryrun.main(["--arch", ARCH, "--shape", "decode_32k,long_500k",
                 "--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[ OK ] 16x16/llama3.2-3b/decode_32k" in out
    assert "[SKIP] 16x16/llama3.2-3b/long_500k" in out
    report = json.loads((tmp_path / "16x16" / ARCH /
                         "decode_32k.json").read_text())
    assert report["chips"] == 256 and report["mesh"] == "16x16"
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "broken", "--shape", "decode_32k",
                     "--multi-pod", "--device", "cpu",
                     "--out", str(tmp_path)])
    assert exc.value.code == 1
    assert "[FAIL] 2x16x16/broken/decode_32k" in capsys.readouterr().out

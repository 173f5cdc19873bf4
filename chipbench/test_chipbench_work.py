"""The yardstick's work counts against hand counts, and the prefill MFU
count against the program's analytic count it departs from."""
import dataclasses

import pytest

from harness import flops, spec

MOE = spec.cell("dsmoe-prefill-2k").config
RWKV = spec.cell("rwkv6-prefill-4k").config


def test_parameter_counts_match_the_program_layout():
    from repro_torch.configs import ARCHS
    from repro_torch.models.module import count_params
    from repro_torch.models.zoo import active_params, build_param_specs
    for cfg in (MOE, RWKV):
        arch = spec.arch_config(cfg)
        assert flops.total_params(cfg) == count_params(
            build_param_specs(arch))
        assert flops.active_params(cfg) == active_params(arch)
    # the files' widths are the program's registry entries, depth aside
    for name, cfg, over in (("deepseek-moe-16b", MOE, {"n_layers": 5}),
                            ("rwkv6-3b", RWKV, {})):
        want = dataclasses.replace(ARCHS[name], source=cfg["source"], **over)
        assert spec.arch_config(cfg) == want


def test_deepseek_counts_by_hand():
    D, V = 2048, 102400
    attn = 4 * D * D
    dense = attn + 3 * D * 10944 + 2 * D
    moe = attn + D * 64 + 64 * 3 * D * 1408 + 3 * D * 2816 + 2 * D
    assert flops.total_params(MOE) == dense + 4 * moe + 2 * V * D + D
    active = dense + 4 * (moe - 58 * 3 * D * 1408) + 2 * V * D + D
    assert flops.active_params(MOE) == active
    assert flops.body_params(MOE) == active - 2 * V * D


def test_train_flops_are_the_program_count_with_attention_per_layer():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.zoo import model_flops
    for cfg, B, n_attn in ((MOE, 4, 5), (RWKV, 2, 0)):
        shape = ShapeConfig("t", "train", 4096, B)
        once = 3.0 * B * 2 * 4096 ** 2 * cfg["n_heads"] * cfg["head_dim"]
        assert flops.train_flops(cfg, B, 4096) == pytest.approx(
            model_flops(spec.arch_config(cfg), shape)
            + max(n_attn - 1, 0) * once, rel=1e-12)


def test_prefill_flops_two_corrections():
    """At full prompts the head counts once a prompt, not at every
    position, and attention in each of the 5 layers; real lengths
    only."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.zoo import model_flops
    arch = spec.arch_config(MOE)
    program = model_flops(arch, ShapeConfig("p", "prefill", 2048, 16))
    head = 2.0 * 102400 * 2048
    ours = flops.prefill_flops(MOE, [2048] * 16)
    attn = 16 * 2 * 2048 ** 2 * 16 * 128
    assert ours == pytest.approx(program - 16 * (2048 - 1) * head
                                 + 4 * attn, rel=1e-12)
    assert program == pytest.approx(4.2e13, rel=0.05)
    assert 16 * 2048 * head == pytest.approx(1.4e13, rel=0.05)
    one = flops.prefill_flops(MOE, [1000])
    assert one == pytest.approx(
        2 * flops.body_params(MOE) * 1000 + 2 * 1000 ** 2 * 16 * 128 * 5
        + head)
    assert flops.attention_flops(RWKV, 4096) == 0.0


def test_moe_gemm_work_by_hand():
    reader = spec.reader("moe_gemm_roofline")
    f, b = reader.work(MOE, 16 * 2048)
    rows = 16 * 2048 * 6
    assert f == 4 * 3 * 2 * rows * 2048 * 1408
    per = 2 * (64 * 2048 * 1408 + rows * 2048 + rows * 1408)
    assert b == 4 * 3 * per
    # FLOP-bound: 13.6 ms at 989 TFLOP/s against 4.5 ms of bytes
    assert reader.least_seconds(MOE, 16 * 2048) == pytest.approx(
        f / 989e12)


def test_rwkv6_scan_work_by_hand():
    reader = spec.reader("rwkv6_scan_roofline")
    ops, nbytes = reader.work(RWKV, [4096] * 16)
    n = 16 * 4096 * 40
    assert ops == 32 * n * (5 * 64 * 64 + 4 * 64 + 2 * 64)
    assert nbytes == 32 * (2 * n * 4 * 64 + 4 * (n * 64 + 40 * 64 +
                                                2 * 16 * 40 * 64 * 64))
    # bytes-bound: about 0.61 ms a layer
    full = reader.least_seconds(RWKV, [4096] * 16)
    assert full / 32 == pytest.approx(6.07e-4, rel=0.01)
    assert full == nbytes / 3.35e12
    # real tokens only: the tokens' work scales, each prompt's state not
    ops, nbytes = reader.work(RWKV, [1000, 3000])
    n = 4000 * 40
    assert ops == 32 * n * (5 * 64 * 64 + 4 * 64 + 2 * 64)
    assert nbytes == 32 * (2 * n * 4 * 64 + 4 * (n * 64 + 40 * 64 +
                                                2 * 2 * 40 * 64 * 64))

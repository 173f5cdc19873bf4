"""MLA's prefill attention kernel (`repro_torch.kernels.mla_attention`) on
the CPU: its plain version (`kernels.ref.mla_attention_ref`, the card
tests' oracle) against the model's blocked attention at the same scale,
the route `variant` chooses by dtype, widths and alignment (a CPU call
of the wrapper always the plain version), the launches
`zoo.kernel_launches` counts, the flash branch's refusal of a scale it
would ignore, and the model's MLA prefill on the CPU, plain and kernel
path, unchanged by the kernel route.  The kernel itself, and the
wrapper's refusal of a CUDA call off its grid, are held on the card by
`tests/test_torch_cuda.py`."""
import dataclasses
import math

import pytest
import torch
from _torch_inputs import normal

from repro_torch.configs import ARCHS, reduce_config
from repro_torch.kernels import mla_attention as mla
from repro_torch.kernels.ref import mla_attention_ref
from repro_torch.models import attention as attn
from repro_torch.models import layers, zoo
from repro_torch.models.module import init_from_specs

torch.set_num_threads(2)

YARN = {"type": "yarn", "factor": 40, "mscale": 0.707,
        "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
        "beta_fast": 32, "beta_slow": 1}


def _operands(B, S, T, H, widths, dtype=torch.float32, seed=0):
    dn, dr, dv = widths
    return tuple(torch.as_tensor(normal(shape, seed + i)).to(dtype)
                 for i, shape in enumerate(((B, S, H, dn + dr),
                                            (B, T, H, dn), (B, T, dr),
                                            (B, T, H, dv))))


@pytest.mark.parametrize("S,T,widths,temp", [
    (1, 1, (128, 64, 128), 1.0),
    (63, 63, (128, 64, 128), 1.5896),
    (64, 64, (32, 16, 32), 1.0),
    (65, 65, (32, 16, 32), 1.5896),
    (130, 130, (16, 8, 12), 0.5),
    (200, 200, (128, 64, 128), 1.5896),
    (40, 100, (32, 16, 32), 1.0),      # causal S != T: the top-left mask
    (100, 40, (32, 16, 32), 1.5896)])
def test_plain_twin_matches_blocked_attention(S, T, widths, temp):
    """float32, the same scale: the twin's one softmax against the
    blocked online softmax over per-head keys `cat`-built as the model's
    plain path builds them (blocks of 32 x 64, so several blocks, ragged
    ones among them)."""
    dn, dr, _ = widths
    q, kn, kr, v = _operands(2, S, T, 3, widths, seed=S + T)
    scale = temp / math.sqrt(dn + dr)
    kf = torch.cat([kn, kr[:, :, None].expand(2, T, 3, dr)], dim=-1)
    want = layers.blocked_attention(q, kf, v, causal=True, block_q=32,
                                    block_kv=64, scale=scale)
    got = mla.mla_attention_fwd(q, kn, kr, v, scale=scale)
    assert got.shape == want.shape == (2, S, 3, widths[2])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case,route", [
    ("deepseek-v2", "mma"), ("reduced", "mma"), ("float32", "plain"),
    ("widths", "plain"), ("rope-width", "plain"), ("q-misaligned", "plain"),
    ("kr-stride", "plain"), ("v-strided-row", "plain")])
def test_variant_routes_by_dtype_widths_and_alignment(case, route):
    widths = {"reduced": (32, 16, 32), "widths": (64, 32, 64),
              "rope-width": (128, 32, 128)}.get(case, (128, 64, 128))
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    q, kn, kr, v = _operands(2, 8, 8, 4, widths, dtype)
    if case == "q-misaligned":        # one element into its storage
        q = torch.zeros(q.numel() + 1, dtype=dtype)[1:].view(q.shape)
    elif case == "kr-stride":         # rows 68 elements apart
        kr = torch.zeros(2, 8, 68, dtype=dtype)[..., :64]
    elif case == "v-strided-row":     # the last axis not contiguous
        v = torch.zeros(2, 8, 4, 256, dtype=dtype)[..., ::2]
    assert mla.variant(q, kn, kr, v) == route


def test_cpu_calls_take_the_plain_twin_at_the_kernels_widths():
    q, kn, kr, v = _operands(2, 70, 70, 4, (32, 16, 32), torch.bfloat16)
    assert mla.variant(q, kn, kr, v) == "mma"
    before = mla.mla_attention_fwd.launches
    got = mla.mla_attention_fwd(q, kn, kr, v, scale=0.2)
    assert mla.mla_attention_fwd.launches == before
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, mla_attention_ref(q, kn, kr, v, scale=0.2))


def test_wrapper_refuses_shapes_that_disagree():
    q, kn, kr, v = _operands(2, 8, 8, 4, (32, 16, 32))
    for args in ((q, kn[..., :16], kr, v), (q, kn, kr[:, :4], v),
                 (q[None], kn, kr, v), (q, kn, kr, v[:, :, :2])):
        with pytest.raises(ValueError):
            mla.mla_attention_fwd(*args, scale=1.0)


@pytest.mark.parametrize("S,T,pairs", [(4096, 4096, (2080, 2016)),
                                       (1, 1, (1, 0)), (64, 64, (1, 0)),
                                       (65, 65, (3, 1)), (1000, 1000,
                                                          (136, 120)),
                                       (100, 40, (2, 0)), (40, 100, (1, 1))])
def test_tile_pairs_count_the_causal_tiles(S, T, pairs):
    assert mla.tile_pairs(S, T) == pairs
    nq, nk = -(-S // 64), -(-T // 64)
    skipped = sum(1 for i in range(nq) for j in range(nk)
                  if 64 * j > min(T, 64 * (i + 1)) - 1)
    assert pairs == (nq * nk - skipped, skipped)


@pytest.mark.parametrize("name,over,prefill", [
    ("deepseek-v2-236b", {}, 60),
    ("deepseek-v2-236b", {"dtype": torch.float32}, 0),
    ("deepseek-v2-236b-smoke", {}, 2),
    ("deepseek-v2-236b-smoke", {"dtype": torch.float32}, 0),
    ("deepseek-v2-236b-smoke-w16", {}, 0)])
def test_kernel_launches_count_the_mla_kernel(name, over, prefill):
    """One launch a layer in a bf16 prefill at widths the kernel is
    compiled for, none in a decode step (the absorbed decode is plain) or
    at other widths or types, where the model runs the blocked
    attention."""
    cfg = ARCHS["deepseek-v2-236b"]
    if name.endswith("-smoke"):
        cfg = reduce_config(cfg)
    elif name.endswith("-w16"):       # head_dim 16: qk 16 + 16, v 16
        cfg = reduce_config(cfg, d_model=64)
    cfg = dataclasses.replace(cfg, **over)
    pre, step = zoo.kernel_launches(cfg)
    assert (pre["mla_attention"], step.get("mla_attention", 0)) == \
        (prefill, 0)


def test_flash_branch_refuses_a_scale_it_would_ignore():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="scale"):
        layers.blocked_attention(q, q, q, kernels=True, scale=0.5)


def _parent_prefill(params, x, positions, *, n_heads, qk_nope, qk_rope,
                    v_dim, kv_lora, rope_theta=1e4, rope_scaling=None,
                    kernels=False):
    """MLA's prefill as the parent commit wrote it: the norms through the
    rmsnorm wrapper on the kernel path, `cat`-built per-head keys, the
    blocked attention's plain branch on both paths, scale None at
    temperature 1."""
    B, S, _ = x.shape
    temp = attn.mla_temperature(rope_scaling)
    if "wq_a" in params:
        q = layers.rmsnorm(x @ params["wq_a"], params["q_norm"],
                           kernels=kernels) @ params["wq_b"]
    else:
        q = x @ params["wq"]
    q = q.reshape(B, S, n_heads, qk_nope + qk_rope)
    qn, qr = q[..., :qk_nope], q[..., qk_nope:]
    qr = layers.apply_rope(qr, positions, rope_theta, rope_scaling)
    kv = x @ params["wkv_a"]
    latent = kv[..., :kv_lora]
    if kernels:
        latent = latent.contiguous()
    ckv = layers.rmsnorm(latent, params["kv_norm"], kernels=kernels)
    kr = layers.apply_rope(kv[..., kv_lora:][:, :, None, :], positions,
                           rope_theta, rope_scaling)[:, :, 0, :]
    kn = (ckv @ params["wk_b"]).reshape(B, S, n_heads, qk_nope)
    vv = (ckv @ params["wv_b"]).reshape(B, S, n_heads, v_dim)
    kr_b = kr[:, :, None, :].expand(B, S, n_heads, qk_rope)
    qf = torch.cat([qn, qr], dim=-1)
    kf = torch.cat([kn, kr_b], dim=-1)
    out = layers.blocked_attention(qf, kf, vv, causal=True, block_q=512,
                                   block_kv=1024, kernels=False,
                                   scale=None if temp == 1.0 else
                                   temp / math.sqrt(qk_nope + qk_rope))
    return out.reshape(B, S, -1) @ params["wo"]


@pytest.mark.parametrize("q_lora", [None, 24])
@pytest.mark.parametrize("rope_scaling", [None, YARN])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_mla_prefill_is_bit_identical_to_the_parents(q_lora,
                                                           rope_scaling,
                                                           dtype):
    kw = dict(n_heads=4, qk_nope=32, qk_rope=16, v_dim=32, kv_lora=64)
    specs = attn.mla_specs(96, kw["n_heads"], kw["qk_nope"], kw["qk_rope"],
                           kw["v_dim"], kw["kv_lora"], dtype, q_lora=q_lora)
    params = init_from_specs(specs, 7, device="cpu")
    x = torch.as_tensor(normal((2, 70, 96), 8)).to(dtype)
    pos = torch.arange(70)[None].expand(2, 70)
    got, _ = attn.mla_attention(params, x, pos, rope_scaling=rope_scaling,
                                **kw)
    want = _parent_prefill(params, x, pos, rope_scaling=rope_scaling, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("q_lora", [None, 24])
@pytest.mark.parametrize("rope_scaling", [None, YARN])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_path_mla_prefill_on_the_cpu_is_the_parents(monkeypatch,
                                                          q_lora,
                                                          rope_scaling,
                                                          dtype):
    """`kernels=True` on CPU tensors, at widths the kernel is compiled
    for: the model never reaches MLA's prefill wrapper, and runs the
    parent's kernel path bit for bit (the rmsnorm wrapper's plain version,
    the blocked attention on per-head keys)."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU prefill reached the MLA kernel's wrapper")

    monkeypatch.setattr(mla, "mla_attention_fwd", refuse)
    kw = dict(n_heads=4, qk_nope=32, qk_rope=16, v_dim=32, kv_lora=64)
    specs = attn.mla_specs(96, kw["n_heads"], kw["qk_nope"], kw["qk_rope"],
                           kw["v_dim"], kw["kv_lora"], dtype, q_lora=q_lora)
    params = init_from_specs(specs, 7, device="cpu")
    x = torch.as_tensor(normal((2, 70, 96), 8)).to(dtype)
    pos = torch.arange(70)[None].expand(2, 70)
    got, _ = attn.mla_attention(params, x, pos, rope_scaling=rope_scaling,
                                kernels=True, **kw)
    want = _parent_prefill(params, x, pos, rope_scaling=rope_scaling,
                           kernels=True, **kw)
    assert torch.equal(got, want)

"""The port's train step (`repro_torch.train.train_step`, `optimizer`)
against the JAX package's, and twins of the reference's training-substrate
tests (`tests/test_train_substrate.py`).

Five steps of `make_train_step` on the reference's tiny llama (2 layers,
d_model 64, vocab 256) in float32, on the reference's weights and the same
`TokenStream` batches, against the reference's jitted step, plain, with 2
microbatches and with int8 gradient compression (`STEP_TOL`).  Each
step's loss, grad norm and lr are held to 1e-5 relative and the step
count exactly.  Tensors are held relative to their largest magnitude:

- m and v (linear in g and g^2) to 1e-5; the float32 sums run in
  another order, and the port lands within 2.6e-6 of the reference.
- The parameters to 2e-4.  AdamW's update m/sqrt(v) does not scale with
  g, so an element whose gradient is a near-cancellation (|g| far below
  its leaf's largest) carries its sum-order error into the update at full
  size.  The reference's own jitted and eager steps differ there by up to
  3.8e-5 of the leaf's magnitude, the port by up to 8.9e-5.
- With compression, parameters, m and v to 1e-2.  A sum-order
  difference that moves a gradient across an int8 rounding boundary
  changes it by one quantum (max |g| / 127).  The reference's own jitted
  and eager steps differ by up to 4.7e-3 in m, 3.0e-3 in v and 1.0e-3 in
  the parameters; the port by up to 3.4e-3.  The carried error `ef` lies
  within half a quantum of zero, so such an element moves by about twice
  the leaf's largest magnitude: `ef` is held to 1e-2 but for at most 0.1%
  of a leaf's elements, each within one quantum (`_close_but_flips`).

The update and the compression are held on identical inputs as well:
`compress_grads` equal to the bit, one `adamw_update` to 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduce_config as ref_reduce
from repro.launch.mesh import compat_make_mesh, compat_set_mesh
from repro.models.module import init_from_specs as ref_init
from repro.models.zoo import build_param_specs as ref_param_specs
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.train_step import TrainStepConfig as RefStepConfig
from repro.train.train_step import init_train_state as ref_init_state
from repro.train.train_step import make_train_step as ref_make_step

from repro_torch.configs import ARCHS, reduce_config
from repro_torch.interop import arch_config_from_dict, params_from_numpy
from repro_torch.models.module import init_from_specs, tree_leaves, tree_map
from repro_torch.models.zoo import build_param_specs
from repro_torch.train.data import DataConfig, TokenStream
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state, opt_state_specs,
                                         schedule)
from repro_torch.train.train_step import (TrainStepConfig, compress_grads,
                                          init_train_state, make_train_step,
                                          train_state_specs)

RTOL = 1e-5
STEPS = 5
CASES = {"plain": dict(), "microbatches": dict(microbatches=2),
         "grad_compress": dict(grad_compress=True)}
# case -> (tolerance of m, v and ef; of the parameters), see the docstring
STEP_TOL = {"plain": (1e-5, 2e-4), "microbatches": (1e-5, 2e-4),
            "grad_compress": (1e-2, 1e-2)}
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=30)


def _tiny(name="llama3.2-3b", dtype=jnp.float32):
    rc = dataclasses.replace(
        ref_reduce(REF_ARCHS[name], n_layers=2, d_model=64, n_heads=2,
                   d_ff=128, vocab=256), dtype=dtype)
    return rc, arch_config_from_dict(dataclasses.asdict(rc))


def _close(got, want, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max() or 1.0))


@pytest.fixture(scope="module")
def tiny():
    rc, pc = _tiny()
    rparams = ref_init(ref_param_specs(rc), jax.random.PRNGKey(0))
    data = TokenStream(DataConfig(vocab=rc.vocab, seq_len=32,
                                  global_batch=8))
    return rc, pc, rparams, [data.global_batch(i) for i in range(STEPS)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_steps_match_the_reference(tiny, case):
    rc, pc, rparams, batches = tiny
    kw = CASES[case]
    rcfg = RefStepConfig(remat=False, opt=RefAdamWConfig(**OPT), **kw)
    pcfg = TrainStepConfig(remat=False, opt=AdamWConfig(**OPT), **kw)
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    rstep = jax.jit(ref_make_step(rc, mesh, rcfg))
    rstate = ref_init_state(rc, rparams, rcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    step = make_train_step(pc, None, pcfg)
    state = init_train_state(pc, params, pcfg)
    rp = rparams
    for b in batches:
        with compat_set_mesh(mesh):
            rp, rstate, rm = rstep(rp, rstate, {k: jnp.asarray(v)
                                                for k, v in b.items()})
        params, state, m = step(params, state, {k: torch.from_numpy(v)
                                                for k, v in b.items()})
        for key in ("loss", "grad_norm", "lr"):
            _close(m[key], rm[key])
    assert int(state["step"]) == int(rstate["step"]) == STEPS
    assert state["step"].dtype == torch.int32
    state_tol, param_tol = STEP_TOL[case]
    for got, want in zip(tree_leaves(params), jax.tree.leaves(rp)):
        _close(got, want, param_tol)
    assert sorted(state) == sorted(rstate)
    for k in state:
        if k != "step":
            check = _close_but_flips if k == "ef" else _close
            for got, want in zip(tree_leaves(state[k]),
                                 jax.tree.leaves(rstate[k])):
                check(got, want, state_tol)


def _close_but_flips(got, want, rtol, max_share=1e-3):
    """`ef` of a compressed step: within `rtol` of its largest magnitude
    but at elements whose int8 rounding flipped, at most `max_share` of
    them, each moved by at most one quantum (twice the largest |ef|, with
    1% to spare)."""
    got, want = got.numpy(), np.asarray(want)
    scale = float(np.abs(want).max())
    off = np.abs(got - want) > rtol * scale
    assert off.mean() <= max_share, off.mean()
    assert np.all(np.abs(got - want)[off] <= 2.02 * scale)


def test_adamw_update_matches_the_reference():
    """One update on identical parameters, gradients and moments (bf16
    and float32 leaves, a vector without weight decay, clipping on)."""
    from repro.train.optimizer import adamw_update as ref_update
    rng = np.random.default_rng(0)
    p = {"w": rng.standard_normal((8, 16)).astype(np.float32),
         "b": rng.standard_normal(16).astype(np.float32),
         "h": rng.standard_normal((4, 8)).astype(np.float32)}
    g = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
         for k, v in p.items()}
    m = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.01
         for k, v in p.items()}
    v = {k: np.abs(rng.standard_normal(v.shape)).astype(np.float32) * 1e-3
         for k, v in p.items()}
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=20)
    rstate = {"m": jax.tree.map(jnp.asarray, m),
              "v": jax.tree.map(jnp.asarray, v), "step": jnp.int32(4)}
    rp = jax.tree.map(jnp.asarray, p)
    rp["h"] = rp["h"].astype(jnp.bfloat16)
    want_p, want_s, want_m = ref_update(RefAdamWConfig(**cfg), rp,
                                        jax.tree.map(jnp.asarray, g), rstate)
    params = tree_map(torch.from_numpy, p)
    params["h"] = params["h"].to(torch.bfloat16)
    state = {"m": tree_map(torch.from_numpy, m),
             "v": tree_map(torch.from_numpy, v),
             "step": torch.tensor(4, dtype=torch.int32)}
    got_p, got_s, got_m = adamw_update(AdamWConfig(**cfg), params,
                                       tree_map(torch.from_numpy, g), state)
    assert got_p is params and got_p["h"].dtype == torch.bfloat16
    assert int(got_s["step"]) == 5
    for k in ("grad_norm", "lr"):
        _close(got_m[k], want_m[k], 1e-6)
    for k in p:
        _close(got_p[k].float(), np.asarray(want_p[k], np.float32), 1e-6)
        _close(got_s["m"][k], want_s["m"][k], 1e-6)
        _close(got_s["v"][k], want_s["v"][k], 1e-6)


def test_compress_grads_matches_the_reference():
    """Quantization, its rounding (half to even) and the carried error
    equal the reference's on the same float32 gradients."""
    g = {"a": np.array([0.5, -1.5, 2.5, 127.0, -0.25], np.float32) / 127.0,
         "b": np.random.default_rng(0).standard_normal((4, 6))
         .astype(np.float32) * 1e-3}
    ef = {"a": np.zeros(5, np.float32),
          "b": np.random.default_rng(1).standard_normal((4, 6))
          .astype(np.float32) * 1e-5}
    from repro.train.train_step import compress_grads as ref_compress
    want, want_ef = ref_compress(jax.tree.map(jnp.asarray, g),
                                 jax.tree.map(jnp.asarray, ef))
    got, got_ef = compress_grads(tree_map(torch.from_numpy, g),
                                 tree_map(torch.from_numpy, ef))
    for k in g:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got_ef[k].numpy(),
                                      np.asarray(want_ef[k]))


def test_schedule_matches_the_reference():
    """The learning rate is float32 arithmetic on the device, as the
    reference's: equal to the last bit over warmup, cosine and floor."""
    from repro.train.optimizer import schedule as ref_schedule
    cfg = AdamWConfig(lr=3e-4, warmup_steps=7, total_steps=40)
    rcfg = RefAdamWConfig(lr=3e-4, warmup_steps=7, total_steps=40)
    steps = np.arange(0, 50, dtype=np.int32)
    got = schedule(cfg, torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref_schedule(rcfg,
                                                       jnp.asarray(steps))),
                               rtol=2e-7)


def test_state_specs_match_the_state():
    rc, pc = _tiny()
    pspecs = build_param_specs(pc)
    scfg = TrainStepConfig(grad_compress=True)
    specs = train_state_specs(pspecs, scfg)
    state = init_train_state(pc, init_from_specs(pspecs, 0, device="cpu"),
                             scfg)
    assert sorted(specs) == sorted(state) == ["ef", "m", "step", "v"]
    for s, t in zip(tree_leaves(specs), tree_leaves(state)):
        assert tuple(s.shape) == tuple(t.shape) and s.dtype == t.dtype
    assert opt_state_specs(pspecs)["step"].dtype == torch.int32


# ---------------------------------------------------------------------------
# twins of tests/test_train_substrate.py
# ---------------------------------------------------------------------------

def _port_tiny():
    cfg = reduce_config(ARCHS["llama3.2-3b"], n_layers=2, d_model=64,
                        n_heads=2, d_ff=128, vocab=256)
    return cfg, init_from_specs(build_param_specs(cfg), 0, device="cpu")


def _tiny_batch(cfg, B=4, S=32, seed=1):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g),
            "labels": torch.randint(0, cfg.vocab, (B, S), generator=g)}


def test_train_loss_decreases():
    cfg, params = _port_tiny()
    scfg = TrainStepConfig(opt=AdamWConfig(lr=3e-3, warmup_steps=2,
                                           total_steps=30))
    step = make_train_step(cfg, None, scfg)
    state = init_train_state(cfg, params, scfg)
    data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))
    losses = []
    for i in range(25):
        batch = {k: torch.from_numpy(v)
                 for k, v in data.global_batch(i).items()}
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


def test_microbatch_equivalence():
    """Grad accumulation over microbatches == single-shot gradients."""
    cfg, params = _port_tiny()
    batch = _tiny_batch(cfg, B=4)
    outs = {}
    for mb in (1, 2):
        scfg = TrainStepConfig(microbatches=mb, remat=False,
                               opt=AdamWConfig(lr=1e-3))
        step = make_train_step(cfg, None, scfg)
        p2, _, m = step(tree_map(torch.clone, params),
                        init_train_state(cfg, params, scfg), batch)
        outs[mb] = (p2, float(m["loss"]))
    # loss averages match; updated params close
    assert abs(outs[1][1] - outs[2][1]) < 5e-2
    for a, b in zip(tree_leaves(outs[1][0]), tree_leaves(outs[2][0])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=0.1, atol=5e-3)


def test_grad_compress_error_feedback():
    """Error feedback keeps the accumulated compressed grads unbiased."""
    g = {"w": torch.tensor([0.3e-2, -1.7e-2, 0.9e-2])}
    ef = {"w": torch.zeros(3)}
    total_deq = torch.zeros(3)
    for _ in range(64):
        deq, ef = compress_grads(g, ef)
        total_deq = total_deq + deq["w"]
    avg = total_deq / 64
    np.testing.assert_allclose(avg.numpy(), g["w"].numpy(), rtol=2e-2,
                               atol=1e-5)


def test_adamw_step_and_clip():
    params = {"w": torch.ones((4, 4))}
    before = params["w"].clone()
    grads = {"w": torch.full((4, 4), 100.0)}  # should be clipped
    state = init_opt_state(params)
    cfg = AdamWConfig(lr=1e-2, clip_norm=1.0, warmup_steps=0, total_steps=10)
    p2, s2, m = adamw_update(cfg, params, grads, state)
    assert float(m["grad_norm"]) > 1.0
    assert int(s2["step"]) == 1
    assert torch.all(p2["w"] < before)

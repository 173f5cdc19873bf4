"""The port's checkpoints (`repro_torch.train.checkpoint`), its data
stream and `resume_or_init`: twins of the checkpoint, data and resume
tests of `tests/test_train_substrate.py`, and the interchange with the
JAX package's checkpoints in both directions, bit for bit (bfloat16
included) with equal manifests.  Like the reference's, the checkpoint
tests skip without the optional `zstandard`."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduce_config as ref_reduce
from repro.models.module import init_from_specs as ref_init
from repro.models.zoo import build_param_specs as ref_param_specs
from repro.train import checkpoint as ref_ckpt
from repro.train.data import DataConfig as RefDataConfig
from repro.train.data import TokenStream as RefTokenStream
from repro.train.train_step import TrainStepConfig as RefStepConfig
from repro.train.train_step import init_train_state as ref_init_state

from repro_torch.configs import ARCHS, reduce_config
from repro_torch.interop import params_from_numpy
from repro_torch.models.module import init_from_specs, tree_leaves, tree_map
from repro_torch.models.zoo import build_param_specs
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, TokenStream
from repro_torch.train.fault_tolerance import resume_or_init
from repro_torch.train.train_step import TrainStepConfig, init_train_state


@pytest.fixture
def zstd():
    if ckpt.zstandard is None:
        pytest.skip("optional 'zstandard' not installed (checkpoint "
                    "compression)")


def _tiny():
    cfg = reduce_config(ARCHS["llama3.2-3b"], n_layers=2, d_model=64,
                        n_heads=2, d_ff=128, vocab=256)
    return cfg, init_from_specs(build_param_specs(cfg), 0, device="cpu")


def _assert_bit_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    assert torch.equal(a, b)


def _ref_state():
    """The reference's bf16 tiny llama and its compressed train state."""
    rc = ref_reduce(REF_ARCHS["llama3.2-3b"], n_layers=2, d_model=64,
                    n_heads=2, d_ff=128, vocab=256)
    rparams = ref_init(ref_param_specs(rc), jax.random.PRNGKey(0))
    opt = ref_init_state(rc, rparams, RefStepConfig(grad_compress=True))
    opt["m"] = jax.tree.map(lambda p: jnp.asarray(p, jnp.float32) * 0.5,
                            rparams)
    opt["step"] = jnp.int32(3)
    return {"params": rparams, "opt": opt}


def _ported(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def test_checkpoint_roundtrip(zstd, tmp_path):
    cfg, params = _tiny()
    tree = {"params": params, "step": torch.tensor(7, dtype=torch.int32)}
    path = ckpt.save(str(tmp_path), 7, tree)
    assert os.path.isdir(path)
    assert ckpt.latest_step(str(tmp_path)) == 7
    restored = ckpt.restore(str(tmp_path), 7, like_tree=tree, device="cpu")
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        _assert_bit_equal(b, a)
    # without a template: every leaf by its path, on the host
    flat = ckpt.restore(str(tmp_path), 7)
    assert flat["['step']"].dtype == torch.int32
    _assert_bit_equal(flat["['params']/['embed']"], params["embed"])
    # a shardings tree of None leaves (no layout) restores the same leaves
    none = ckpt.restore(str(tmp_path), 7, like_tree=tree, device="cpu",
                        shardings=tree_map(lambda _: None, tree))
    for a, b in zip(tree_leaves(restored), tree_leaves(none)):
        _assert_bit_equal(b, a)


def test_checkpoint_atomic_no_partial(zstd, tmp_path):
    cfg, params = _tiny()
    ckpt.save(str(tmp_path), 1, {"p": params})
    # a .tmp dir must never be visible as a checkpoint
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_save_and_restore_need_zstandard(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt, "zstandard", None)
    with pytest.raises(ModuleNotFoundError, match="zstandard"):
        ckpt.save(str(tmp_path), 1, {"x": torch.ones(2)})
    with pytest.raises(ModuleNotFoundError, match="zstandard"):
        ckpt.restore(str(tmp_path), 1)


def test_async_save_keeps_the_values_before_an_in_place_update(zstd,
                                                               tmp_path):
    """The port's optimizer updates in place: an asynchronous save copies
    every leaf to the host before it returns."""
    cfg, params = _tiny()
    state = init_train_state(cfg, params, TrainStepConfig())
    tree = {"params": params, "opt": state}
    before = tree_map(torch.clone, tree)
    ckpt.save(str(tmp_path), 5, tree, blocking=False)
    for leaf in tree_leaves(tree):      # what the next step does
        leaf.add_(1)
    ckpt.wait_for_async()
    restored = ckpt.restore(str(tmp_path), 5, like_tree=before)
    for a, b in zip(tree_leaves(before), tree_leaves(restored)):
        _assert_bit_equal(b, a)


def test_reference_checkpoint_restores_in_the_port(zstd, tmp_path):
    tree = _ref_state()
    ref_ckpt.save(str(tmp_path), 9, tree)
    like = tree_map(torch.zeros_like, _ported(tree))
    got = ckpt.restore(str(tmp_path), 9, like_tree=like, device="cpu")
    want = _ported(tree)
    assert got["params"]["embed"].dtype == torch.bfloat16
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        _assert_bit_equal(a, b)


def test_port_checkpoint_restores_in_the_reference(zstd, tmp_path):
    tree = _ref_state()
    ckpt.save(str(tmp_path / "port"), 9, _ported(tree))
    ref_ckpt.save(str(tmp_path / "ref"), 9, tree)
    manifests = [json.loads((tmp_path / d / "step_00000009" /
                             "manifest.json").read_text())
                 for d in ("port", "ref")]
    assert manifests[0] == manifests[1]
    assert {"path": "['params']/['embed']", "dtype": "bfloat16"}.items() <= \
        next(m for m in manifests[0]["leaves"]
             if m["path"] == "['params']/['embed']").items()
    got = ref_ckpt.restore(str(tmp_path / "port"), 9, like_tree=tree)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(
            np.asarray(a).reshape(-1).view(np.uint8),
            np.asarray(b).reshape(-1).view(np.uint8))


def test_data_pipeline_deterministic_and_shardable():
    cfg = DataConfig(vocab=512, seq_len=16, global_batch=8, seed=3)
    ds = TokenStream(cfg)
    a = ds.global_batch(5)
    b = ds.global_batch(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = ds.global_batch(6)
    assert not np.array_equal(a["tokens"], c["tokens"])
    # shards are deterministic slices of the same step
    s0 = ds.batch(5, shard=0, n_shards=2)
    s0b = ds.batch(5, shard=0, n_shards=2)
    np.testing.assert_array_equal(s0["tokens"], s0b["tokens"])
    # labels are next-token shifted
    seq = np.concatenate([a["tokens"][:, :1], a["labels"]], axis=1)
    np.testing.assert_array_equal(seq[:, 1:], a["labels"])
    # the reference's stream gives the same batches
    want = RefTokenStream(RefDataConfig(vocab=512, seq_len=16,
                                        global_batch=8, seed=3))
    for step in (0, 5):
        for k, v in want.batch(step, 1, 2).items():
            np.testing.assert_array_equal(ds.batch(step, 1, 2)[k], v)


def test_resume_or_init(zstd, tmp_path):
    tree = {"x": torch.arange(4)}
    got, step = resume_or_init(str(tmp_path), lambda: tree)
    assert step == 0
    ckpt.save(str(tmp_path), 12, tree)
    got, step = resume_or_init(str(tmp_path), lambda: tree, like_tree=tree)
    assert step == 12
    np.testing.assert_array_equal(got["x"].numpy(), np.arange(4))

"""The port's batched fitness (`repro_torch.core.vectorized`) and its
serialization kernel's plain version against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages; design
points cross over through `repro_torch.interop`.  The reference's serialize
path runs its Pallas kernel in interpret mode, as its own tests do on the
CPU.  Scores are float32 in both packages and are held at rtol 1e-5, the
tolerance of the reference's own kernel-vs-jnp test: the port sums in
another order than XLA (measured maximum 1.4e-7 relative, one float32 ulp,
on these setups).  The chiplet architectures are in
`test_torch_vectorized_chiplets.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_inputs import RTOL, queues
from _torch_parity import check_lower_bound, check_scores, make_pair

from repro.kernels.ref import prefix_max as ref_prefix_max
from repro.kernels.ref import prefix_sum as ref_prefix_sum
from repro.kernels.ref import serialize_prefix_ref as ref_serialize_ref
from repro.kernels.wavefront import serialize_prefix as ref_serialize_pallas

from repro_torch.kernels.ref import prefix_max, prefix_sum, \
    serialize_prefix_ref
from repro_torch.kernels.wavefront import serialize_prefix

torch.set_num_threads(2)


@pytest.mark.parametrize("w", [1, 7, 17, 28, 33, 40])
def test_plain_serialize_matches_reference(w):
    free0, release, dur = queues(24, w, seed=w)
    fin, free = serialize_prefix_ref(*map(torch.from_numpy,
                                          (free0, release, dur)))
    want_ref = ref_serialize_ref(*map(jnp.asarray, (free0, release, dur)))
    want_pallas = ref_serialize_pallas(*map(jnp.asarray,
                                            (free0, release, dur)),
                                       interpret=True)
    for want_fin, want_free in (want_ref, want_pallas):
        np.testing.assert_allclose(fin.numpy(), np.asarray(want_fin),
                                   rtol=RTOL)
        np.testing.assert_allclose(free.numpy(), np.asarray(want_free),
                                   rtol=RTOL)


@pytest.mark.parametrize("w", [1, 5, 16, 33])
def test_prefix_ops_match_reference(w):
    x = np.random.default_rng(w).uniform(-5, 5, size=(3, w)) \
        .astype(np.float32)
    np.testing.assert_allclose(prefix_sum(torch.from_numpy(x)).numpy(),
                               np.asarray(ref_prefix_sum(jnp.asarray(x))),
                               rtol=RTOL, atol=1e-6)
    assert np.array_equal(prefix_max(torch.from_numpy(x)).numpy(),
                          np.asarray(ref_prefix_max(jnp.asarray(x))))


def test_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors the kernel wrapper is the plain version, with leading
    axes kept, and it counts no launch."""
    free0, release, dur = queues(12, 9, seed=3)
    args = (torch.from_numpy(free0).reshape(3, 4),
            torch.from_numpy(release).reshape(3, 4, 9),
            torch.from_numpy(dur).reshape(3, 4, 9))
    before = serialize_prefix.launches
    fin, free = serialize_prefix(*args)
    want_fin, want_free = serialize_prefix_ref(*args)
    assert serialize_prefix.launches == before
    assert fin.shape == (3, 4, 9) and free.shape == (3, 4)
    assert torch.equal(fin, want_fin) and torch.equal(free, want_free)
    with pytest.raises(ValueError):
        serialize_prefix(args[0][:, :3], args[1], args[2])
    with pytest.raises(ValueError):
        serialize_prefix(args[0], args[1][..., :0], args[2][..., :0])


@pytest.fixture(scope="module", params=["mc_hetero", "mc_hom_tpu"])
def pair(request):
    return make_pair(request.param)


@pytest.mark.parametrize("contention", ["backlog", "serialize"])
@pytest.mark.parametrize("priority", ["latency", "memory"])
def test_scores_match_reference(pair, priority, contention):
    check_scores(pair, priority, contention)


def test_latency_lower_bound_equal(pair):
    check_lower_bound(pair)

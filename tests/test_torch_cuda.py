"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and `nvcc`; elsewhere they skip.  On a
machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch
from _torch_inputs import RTOL, population, queues

from repro_torch.api.session import ExplorationSession
from repro_torch.configs.paper_workloads import squeezenet
from repro_torch.core.vectorized import BatchedFitness
from repro_torch.hw.catalog import mc_hetero, mc_hom_tpu_chip4
from repro_torch.kernels.ref import serialize_prefix_ref
from repro_torch.kernels.wavefront import serialize_prefix

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("rows,w", [(1, 1), (5, 7), (1280, 17), (2048, 28),
                                    (40, 33), (300, 257)])
def test_serialize_kernel_matches_plain(cuda, rows, w):
    args = [torch.as_tensor(a, device=cuda) for a in queues(rows, w, rows)]
    before = serialize_prefix.launches
    fin, free = serialize_prefix(*args)
    assert serialize_prefix.launches == before + 1
    want_fin, want_free = serialize_prefix_ref(*args)
    torch.cuda.synchronize()
    if w <= 32:   # one tile: the same shift-doubling sum order
        assert torch.equal(fin, want_fin) and torch.equal(free, want_free)
    torch.testing.assert_close(fin, want_fin, rtol=RTOL, atol=0.0)
    torch.testing.assert_close(free, want_free, rtol=RTOL, atol=0.0)


def test_serialize_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    free0, release, dur = (torch.as_tensor(a, device=cuda)
                           for a in queues(8, 5, 0))
    with pytest.raises(TypeError):
        serialize_prefix(free0.double(), release.double(), dur.double())
    with pytest.raises(ValueError):
        serialize_prefix(free0, release.t().contiguous().t(), dur)
    with pytest.raises(ValueError):
        serialize_prefix(free0.cpu(), release, dur)


@pytest.mark.parametrize("arch", [mc_hetero, mc_hom_tpu_chip4])
def test_fitness_kernel_path_matches_plain_and_cpu(cuda, arch):
    acc = arch()
    w = squeezenet()
    engine = ExplorationSession(device=cuda).engine(w, acc, ("tile", 8, 1))
    pop = population(w, acc, 16, seed=1)
    kern = BatchedFitness(engine, device=cuda)
    assert kern.contention == "serialize"
    before = serialize_prefix.launches
    s_k = kern.scores(pop)
    assert serialize_prefix.launches - before == kern.n_wavefronts * (
        2 if kern.comm else 1)
    s_p = BatchedFitness(engine, device=cuda, use_kernel=False).scores(pop)
    s_c = BatchedFitness(engine, device="cpu",
                         contention="serialize").scores(pop)
    np.testing.assert_allclose(s_k, s_p, rtol=RTOL)
    np.testing.assert_allclose(s_k, s_c, rtol=RTOL)

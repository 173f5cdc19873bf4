"""The port's batched fitness against the JAX package's on the 2- and
4-chiplet architectures (inter-chiplet link channels), at the tolerance and
on the set-up of `test_torch_vectorized.py`."""
import pytest
import torch
from _torch_parity import check_lower_bound, check_scores, make_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["mc_hom_tpu_chip2",
                                        "mc_hom_tpu_chip4"])
def pair(request):
    return make_pair(request.param)


@pytest.mark.parametrize("contention", ["backlog", "serialize"])
@pytest.mark.parametrize("priority", ["latency", "memory"])
def test_scores_match_reference_chiplets(pair, priority, contention):
    check_scores(pair, priority, contention)


def test_latency_lower_bound_equal_chiplets(pair):
    check_lower_bound(pair)

"""Contract of the port's batched fitness (`repro_torch.core.vectorized`),
on the CPU: twins of the JAX package's `tests/test_vectorized.py`.

The vectorized path ranks, it never scores a stored metric: positive rank
correlation with the exact engine across priorities, heterogeneous cores and
1/2/4-chiplet topologies; a latency lower bound that never exceeds the exact
schedule; an exact `rescore`; batch-size invariance; and `explore(prefilter=
True)` bit-identical to the unfiltered search with the prefilter firing.
"""
import numpy as np
import pytest
import torch
from _torch_inputs import population

from repro_torch.api.session import ExplorationSession
from repro_torch.configs.paper_workloads import squeezenet
from repro_torch.core import CostModel, build_graph
from repro_torch.core.allocator import feasible_cores_per_layer
from repro_torch.core.ga import GeneticAllocator
from repro_torch.core.scheduler import ScheduleEngine
from repro_torch.core.vectorized import BatchedFitness, \
    get_batched_fitness, rank_correlation
from repro_torch.hw.catalog import mc_hetero, mc_hom_tpu, \
    mc_hom_tpu_chip2, mc_hom_tpu_chip4

torch.set_num_threads(2)

GRAN = ("tile", 8, 1)
CPU = "cpu"


def _engine(acc):
    w = squeezenet()
    return w, ScheduleEngine(build_graph(w, acc, GRAN), CostModel(w, acc),
                             acc)


@pytest.fixture(scope="module", params=["mc_hetero", "chip1", "chip2",
                                        "chip4"])
def arch_setup(request):
    acc = {"mc_hetero": mc_hetero, "chip1": mc_hom_tpu,
           "chip2": mc_hom_tpu_chip2, "chip4": mc_hom_tpu_chip4}[
               request.param]()
    w, engine = _engine(acc)
    return w, acc, engine


@pytest.mark.parametrize("priority", ["latency", "memory"])
def test_rank_correlation_and_lower_bound(arch_setup, priority):
    """The reference's floors: near-perfect ranking on the heterogeneous
    quad-core, positive latency-priority ranking on the homogeneous and
    chiplet architectures, and a lower bound under every exact latency."""
    w, acc, engine = arch_setup
    hetero = acc.name == mc_hetero().name
    pop = population(w, acc, 24, spread=True)
    bf = get_batched_fitness(engine, priority=priority, device=CPU)
    exact = engine.evaluate_population(pop, priority)
    approx = bf.scores(pop)
    assert approx.shape == exact.shape
    assert np.all(np.isfinite(approx)) and np.all(approx > 0)
    if hetero:
        assert rank_correlation(approx[:, 0], exact[:, 0]) > 0.5
        assert rank_correlation(approx[:, 1], exact[:, 1]) > 0.5
    elif priority == "latency":
        assert rank_correlation(approx[:, 0], exact[:, 0]) > 0.3
        assert rank_correlation(approx[:, 1], exact[:, 1]) > 0.25
    lb = bf.latency_lower_bound(pop)
    assert np.all(lb <= exact[:, 0] * (1 + 1e-9))
    assert np.all(lb > 0)


def test_rescore_is_exact_oracle(arch_setup):
    w, acc, engine = arch_setup
    pop = population(w, acc, 6, seed=3)
    bf = get_batched_fitness(engine, device=CPU)
    assert np.array_equal(bf.rescore(pop),
                          engine.evaluate_population(pop, "latency"))
    lat, en = engine.evaluate(pop[0])
    assert tuple(bf.rescore(pop[0])[0]) == (lat, en)


def test_contention_models_both_rank(arch_setup):
    w, acc, engine = arch_setup
    pop = population(w, acc, 24, seed=9, spread=True)
    exact = engine.evaluate_population(pop, "latency")
    for contention in ("backlog", "serialize"):
        s = get_batched_fitness(engine, contention=contention,
                                device=CPU).scores(pop)
        assert np.all(np.isfinite(s)) and np.all(s > 0)
        assert rank_correlation(s[:, 0], exact[:, 0]) > 0.25


def test_batch_size_invariance():
    acc = mc_hetero()
    w, engine = _engine(acc)
    pop = population(w, acc, 16, seed=5)
    for contention in ("backlog", "serialize"):
        bf = get_batched_fitness(engine, contention=contention, device=CPU)
        full = bf.scores(pop)
        np.testing.assert_allclose(bf.scores(pop[:5]), full[:5], rtol=1e-12)
        np.testing.assert_allclose(bf.scores(pop[7:8]), full[7:8],
                                   rtol=1e-12)


def test_kernel_wrapper_and_plain_paths_agree_on_cpu():
    """`use_kernel` picks the wrapper, which on CPU tensors is the plain
    version: both paths give the same scores, bit for bit."""
    acc = mc_hetero()
    w, engine = _engine(acc)
    pop = population(w, acc, 8, seed=7)
    on = BatchedFitness(engine, contention="serialize", use_kernel=True,
                        device=CPU)
    off = BatchedFitness(engine, contention="serialize", use_kernel=False,
                         device=CPU)
    assert np.array_equal(on.scores(pop), off.scores(pop))


def test_device_defaults_and_cache_key(monkeypatch):
    """None means CUDA and raises without it; the CPU default contention is
    "backlog"; the fitness cache is keyed on the device."""
    acc = mc_hetero()
    _, engine = _engine(acc)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedFitness(engine)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_batched_fitness(engine)
    with pytest.raises(RuntimeError, match="CUDA"):
        ExplorationSession().explore(squeezenet(), acc, GRAN, pop_size=4,
                                     generations=1, prefilter=True)
    bf = get_batched_fitness(engine, device=CPU)
    assert bf.contention == "backlog" and bf.device.type == "cpu"
    assert get_batched_fitness(engine, device=torch.device("cpu")) is bf
    assert (get_batched_fitness(engine, device=CPU, contention="serialize")
            is not bf)


def test_prefilter_keep_one_is_noop():
    acc = mc_hetero()
    w, engine = _engine(acc)
    feas = feasible_cores_per_layer(w, acc)
    bf = get_batched_fitness(engine, device=CPU)

    def _run(**kw):
        engine.reset_checkpoints()
        return GeneticAllocator(
            n_genes=len(feas), feasible_cores=feas,
            evaluate_population=lambda m: engine.evaluate_population(
                m, "latency"),
            pop_size=10, generations=4, seed=0, **kw).run()

    base = _run()
    keep_all = _run(prefilter=bf.prefilter("edp"), prefilter_keep=1.0)
    assert np.array_equal(base.best_genome, keep_all.best_genome)
    assert np.array_equal(base.best_objs, keep_all.best_objs)
    assert keep_all.prefilter_screened == 0
    assert keep_all.prefilter_pruned == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_explore_prefilter_bit_identity(seed):
    """On the reference's committed seed/budget combos, the port's explore
    with the prefilter on reproduces its unfiltered search bit for bit, with
    the prefilter firing."""
    sess = ExplorationSession(device=CPU)
    w, acc = squeezenet(), mc_hetero()
    engine = sess.engine(w, acc, ("tile", 32, 1))
    runs = {}
    for pf in (False, True):
        engine.reset_checkpoints()
        runs[pf] = sess.explore(
            w, acc, granularity=("tile", 32, 1), objective="edp",
            priority="latency", pop_size=16, generations=8, seed=seed,
            prefilter=pf)
    r0, r1 = runs[False], runs[True]
    assert r1.ga.prefilter_screened > 0
    assert r1.ga.prefilter_pruned > 0
    assert r0.latency_cc == r1.latency_cc
    assert r0.energy_pj == r1.energy_pj
    assert r0.peak_mem_bytes == r1.peak_mem_bytes
    assert np.array_equal(r0.allocation, r1.allocation)
    assert r1.ga.evaluations <= r0.ga.evaluations

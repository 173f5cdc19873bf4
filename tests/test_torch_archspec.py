"""Content keys of the port's DSE runtime equal the JAX package's: every
catalog architecture's `ArchSpec` (its JSON and its key, after a round
trip through `Accelerator`, dict and JSON), every `DesignPoint` of the
paper's workloads x the catalog x `DEFAULT_GRANULARITIES`, and the
nearest-architecture walk.  Both sides build from their own catalog and
workload registry, so a store keyed by one package is addressed by the
other."""
import pytest
from _torch_dse import spaces

import repro.api as R
import repro.configs.paper_workloads as ref_workloads

import repro_torch.api as T
import repro_torch.configs.paper_workloads as port_workloads

CATALOG = list(R.catalog_specs())
PAPER_WORKLOADS = ["resnet18", "mobilenetv2", "squeezenet", "tiny_yolo",
                   "fsrcnn", "resnet50_segment", "resnet18_first_segment"]


def test_catalog_names_and_granularities_equal():
    assert list(T.catalog_specs()) == CATALOG
    assert T.DEFAULT_GRANULARITIES == R.DEFAULT_GRANULARITIES
    assert [T.granularity_label(g) for g in T.DEFAULT_GRANULARITIES] == \
        [R.granularity_label(g) for g in R.DEFAULT_GRANULARITIES]


@pytest.mark.parametrize("name", CATALOG)
def test_arch_spec_round_trips_and_key_equals_reference(name):
    spec = T.catalog_specs([name])[name]
    assert T.ArchSpec.from_dict(spec.to_dict()) == spec
    assert T.ArchSpec.from_json(spec.to_json()) == spec
    assert T.ArchSpec.from_accelerator(spec.to_accelerator()) == spec
    want = R.catalog_specs([name])[name]
    assert spec.to_json() == want.to_json()
    assert spec.content_key() == want.content_key()


@pytest.mark.parametrize("workload", PAPER_WORKLOADS)
def test_design_point_keys_equal_reference(workload):
    rw = getattr(ref_workloads, workload)()
    pw = getattr(port_workloads, workload)()
    assert repr(pw.cache_key()) == repr(rw.cache_key())
    ref = R.DesignSpace(workloads={workload: rw}, archs=R.catalog_specs(),
                        granularities=list(R.DEFAULT_GRANULARITIES))
    port = T.DesignSpace(workloads={workload: pw}, archs=T.catalog_specs(),
                         granularities=list(T.DEFAULT_GRANULARITIES))
    want = [(p.content_key(), p.spec_dict()) for p in ref]
    got = [(p.content_key(), p.spec_dict()) for p in port]
    assert len(got) == len(CATALOG) * len(R.DEFAULT_GRANULARITIES)
    assert got == want


def test_nearest_arch_order_equals_reference():
    specs_r, specs_t = R.catalog_specs(), T.catalog_specs()
    assert T.nearest_arch_chain(list(specs_t.values())) == \
        R.nearest_arch_chain(list(specs_r.values()))
    ref, port = spaces(["squeezenet", "fsrcnn"],
                       {n: n for n in ("sc_tpu", "mc_hetero", "mc_hom_tpu",
                                       "sc_eye", "mc_hom_eye")},
                       ["layer", ("tile", 8, 1)])
    for order in ("declared", "nearest-arch"):
        assert [p.content_key() for p in T.order_points(port, order)] == \
            [p.content_key() for p in R.order_points(ref, order)]

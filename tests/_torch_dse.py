"""Shared set-up of the tests that hold the port's DSE runtime
(`repro_torch.api`, `repro_torch.obs`, `repro_torch.serve.simulator`)
against the JAX package's: the same design space declared in both packages,
each from its own catalog and workload registry, and record comparisons
that leave out the one field that is wall time."""
import repro.api as R
import repro.hw.catalog as ref_catalog

import repro_torch.api as T
import repro_torch.hw.catalog as port_catalog


def spaces(workloads, archs, granularities, serving=None, **ga):
    """(reference space, port space) over the same axes: `workloads` are
    registry names or {name: (ref factory, port factory)}, `archs` maps a
    label to a catalog function name, `ga` holds `GAConfig` fields."""
    out = []
    for api, catalog, side in ((R, ref_catalog, 0), (T, port_catalog, 1)):
        wl = workloads if not isinstance(workloads, dict) else \
            {name: pair[side] for name, pair in workloads.items()}
        kw = {}
        if serving is not None:
            kw["serving"] = api.ServingSweep(**serving)
        out.append(api.DesignSpace(
            workloads=wl,
            archs={label: getattr(catalog, fn) for label, fn in archs.items()},
            granularities=list(granularities), ga=api.GAConfig(**ga), **kw))
    return tuple(out)


def content(record) -> dict:
    """A record's stored fields but `runtime_s`, the operator's wall time."""
    d = record.to_dict()
    d.pop("runtime_s")
    return d


def contents(records) -> list:
    return [content(r) for r in records]


def failure_content(failure) -> dict:
    """A `FailureRecord`'s fields, the traceback cut to its last line with
    the exception's module named as in the reference: the frames above it
    name each package's own files."""
    d = failure.to_dict()
    last = d["traceback"].strip().splitlines()[-1:]
    d["traceback"] = [line.replace("repro_torch.", "repro.") for line in last]
    return d

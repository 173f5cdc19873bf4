"""Sweep-native exploration API: declarative specs, spaces, and sessions.

    from repro_torch.api import ArchSpec, DesignSpace, ExplorationSession

`ArchSpec` declares hardware as data — including chiplet topologies
(`TopologySpec`: core clusters, inter-cluster links, hop tables) —
`DesignSpace` declares the sweep as a constrained cross-product, and
`ExplorationSession` executes it (serial or multi-process) against a
persistent content-keyed result store.  The legacy one-call API
(`repro_torch.core.explore`) is a thin wrapper over a default session.

The distributed sweep runtime rides on the same pieces: `build_manifest` /
`shard` freeze a space into self-contained JSON shard manifests,
`run_shard` executes one on any machine, `ResultStore.merge` /
`merge_stores` fold the per-shard stores back into the serial run's exact
record set, and `ExplorationSession.run_async` streams records through
`StopPolicy` objects (`BudgetPolicy`, `PlateauPolicy`,
`ParetoStagnationPolicy`, `TargetMetricPolicy`, `HeartbeatMonitor`) for
early-stopping (and supervised) sweeps.

The runtime is fault-tolerant (`repro_torch.api.resilience`): per-point failures
are retried under a `RetryPolicy` (seeded deterministic backoff) and
quarantined as content-keyed `FailureRecord`s on exhaustion — never fatal —
while a seeded `FaultInjector` makes every recovery path testable.  Under
any injected fault schedule within the retry budget, the healthy record
set stays bit-identical to a fault-free serial run.

`DEFAULT_GRANULARITIES` (re-exported from `repro_torch.api.session`) is the
granularity axis used by `ExplorationSession.explore_granularity` when none
is given: whole layers plus 8/16/32/64 row-band tilings.
"""
from repro_torch.api.archspec import ArchSpec, CoreSpec, as_arch_spec, catalog_specs
from repro_torch.api.designspace import DesignPoint, DesignSpace, GAConfig, \
    ServingSweep, arch_spec_similarity, fits_weights_on_chip, \
    granularity_label, max_clusters, max_cores, min_act_mem, \
    nearest_arch_chain, order_points
from repro_torch.api.session import (DEFAULT_GRANULARITIES, ExplorationRecord,
                               ExplorationSession, FifoCache,
                               GranularitySweep, ProcessExecutor, ResultStore,
                               SerialExecutor, SweepExecutor, SweepResult,
                               best_record, default_session, pareto_records,
                               pivot_records)
from repro_torch.api.policies import (BudgetPolicy, HeartbeatMonitor,
                                ParetoStagnationPolicy, PlateauPolicy,
                                StopPolicy, TargetMetricPolicy)
from repro_torch.api.resilience import (FailureRecord, FaultInjector, InjectedFault,
                                  PointOutcome, RetryPolicy,
                                  StoreCorruptionError, StoreLockError)
from repro_torch.api.distributed import (SweepManifest, build_manifest,
                                   merge_stores, run_shard, shard)
from repro_torch.hw.topology import (ClusterSpec, LinkSpec, TopologySpec,
                               partition_topology)

__all__ = [
    "ArchSpec", "CoreSpec", "as_arch_spec", "catalog_specs",
    "TopologySpec", "ClusterSpec", "LinkSpec", "partition_topology",
    "DesignPoint", "DesignSpace", "GAConfig", "ServingSweep",
    "granularity_label",
    "min_act_mem", "max_cores", "max_clusters", "fits_weights_on_chip",
    "arch_spec_similarity", "nearest_arch_chain", "order_points",
    "ExplorationSession", "ExplorationRecord", "SweepResult",
    "GranularitySweep", "ResultStore", "FifoCache", "DEFAULT_GRANULARITIES",
    "SweepExecutor", "SerialExecutor", "ProcessExecutor",
    "StopPolicy", "BudgetPolicy", "PlateauPolicy", "ParetoStagnationPolicy",
    "TargetMetricPolicy", "HeartbeatMonitor",
    "RetryPolicy", "FailureRecord", "FaultInjector", "PointOutcome",
    "InjectedFault", "StoreCorruptionError", "StoreLockError",
    "SweepManifest", "build_manifest", "shard", "run_shard", "merge_stores",
    "best_record", "pareto_records", "pivot_records", "default_session",
]

"""Serving layer: the batched token engine and the closed-loop simulator.

The pure-Python pieces (`arrivals`, `batching`, `workloads`, `simulator`)
import eagerly; the torch token engine (`engine`) is reached lazily via
``repro_torch.serve.engine`` so analytic serving sweeps never pay a torch
import.
"""
from repro_torch.serve.arrivals import (RequestSpec, poisson_trace,
                                        trace_from_jsonable, trace_to_jsonable,
                                        uniform_trace, validate_trace)
from repro_torch.serve.batching import SlotBatcher
from repro_torch.serve.simulator import (PhaseCosts, RequestOutcome,
                                         ServingRecord, ServingSimResult,
                                         ServingSweepResult, simulate)
from repro_torch.serve.workloads import (SERVING_WORKLOADS, decode_phase_of,
                                         rwkv_phases, serving_workload,
                                         ssm_phases, transformer_phases)

__all__ = [
    "RequestSpec", "poisson_trace", "uniform_trace", "validate_trace",
    "trace_to_jsonable", "trace_from_jsonable", "SlotBatcher",
    "PhaseCosts", "RequestOutcome", "ServingSimResult", "ServingRecord",
    "ServingSweepResult", "simulate", "SERVING_WORKLOADS",
    "decode_phase_of", "serving_workload", "transformer_phases",
    "rwkv_phases", "ssm_phases",
]

"""Stream Step 3 substrate: ZigZag-lite single-core mapping cost model.

Stream interfaces with ZigZag [28]/LOMA [36] to get, per unique (CN x core)
pair, the optimal intra-core mapping's energy / latency / utilization. We
implement the parts Stream consumes:

* spatial mapping: the CN's loops are laid over the core's spatial unrolling;
  dims absent from the CN under-utilize the array (paper Sec. III-A.2),
* dataflow-driven register reuse: inputs broadcast across K-unrolled columns,
  weights reused across output-spatial unrolling, partial sums reduced across
  C/FY/FX unrolling (classic dataflow taxonomy, Eyeriss [5]),
* temporal mapping: reduction loops innermost (output-stationary registers),
  so partial sums do not round-trip SRAM; per-level access counts follow,
* the DATE'22 uniform latency model [29]: ideal cycles plus stall cycles when
  the per-cycle on-core SRAM traffic exceeds the SRAM port bandwidth.

All constants are per-core calibratable; Table-I validation (benchmarks)
fixes them against the three measured chips.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

from repro_torch.core.workload import LOOP_DIMS
from repro_torch.hw.core_model import CoreModel

# spatial reuse directions per operand (which unrolled dims reuse the operand)
_INPUT_REUSE_DIMS = ("K",)              # one input broadcast to all K columns
_WEIGHT_REUSE_DIMS = ("B", "OY", "OX")  # weights shared across output pixels
_OUTPUT_REDUCE_DIMS = ("C", "FY", "FX")  # psums accumulate across these


@dataclasses.dataclass(frozen=True)
class CNCost:
    cycles: float           # modeled execution latency on the core (cc)
    ideal_cycles: float     # bandwidth-unconstrained cycles
    energy_pj: float        # compute + on-core SRAM energy
    spatial_util: float     # MACs / (cycles * PEs)
    sram_bits: float        # total on-core SRAM traffic (for bw accounting)
    breakdown: Mapping[str, float]


def cn_cost(dims: Mapping[str, int], op: str, core: CoreModel, bits: int = 8) -> CNCost:
    """Cost of one CN (loop extents `dims`, operator `op`) on `core`."""
    d = {k: int(dims.get(k, 1)) for k in LOOP_DIMS}
    unroll = core.unroll
    macs = math.prod(d.values())
    if op in ("add", "concat", "pool"):
        # elementwise/pool SIMD work: one op per output element (x FY*FX for pool)
        work = d["B"] * d["K"] * d["OY"] * d["OX"] * (d["FY"] * d["FX"] if op == "pool" else 1)
        lanes = core.n_pe
        ideal = math.ceil(work / lanes)
        in_bits = work * bits
        out_bits_ = d["B"] * d["K"] * d["OY"] * d["OX"] * bits
        sram_bits = in_bits + out_bits_
        stall = max(1.0, (sram_bits / max(ideal, 1)) / core.sram_bw_bits_per_cc)
        cycles = ideal * stall * core.latency_overhead
        e = (work * core.mac_energy_pj * 0.2          # ALU op ~ cheaper than MAC
             + sram_bits * core.act_energy_pj_per_bit)
        return CNCost(cycles, ideal, e, work / max(cycles * lanes, 1), sram_bits,
                      {"compute": work * core.mac_energy_pj * 0.2,
                       "sram_act": sram_bits * core.act_energy_pj_per_bit,
                       "sram_w": 0.0})

    # ---- spatial mapping: temporal iterations after unrolling ----------------
    if core.core_type == "aimc":
        # Flexible IMC packing (Jia et al. [21], DIANA [38]): the flattened
        # filter (C*FY*FX) is unrolled along the bit-cell rows, output
        # channels along the columns; one array activation per output pixel
        # per (row-tile x col-tile), `aimc_cc_per_op` cycles each (input-bit
        # serialism + ADC conversion).
        rows = math.prod(u for dim, u in core.dataflow if dim in ("C", "FY", "FX"))
        cols = unroll.get("K", 1)
        filt = d["C"] * d["FY"] * d["FX"]
        activations = (math.ceil(filt / rows) * math.ceil(d["K"] / cols)
                       * d["B"] * d["OY"] * d["OX"])
        ideal = activations * core.aimc_cc_per_op
        temporal = activations
    else:
        temporal = 1
        for dim, ext in d.items():
            temporal *= math.ceil(ext / unroll.get(dim, 1))
        ideal = temporal

    # ---- register-level spatial reuse -> SRAM access counts ------------------
    in_reuse = math.prod(min(unroll.get(x, 1), d[x]) for x in _INPUT_REUSE_DIMS)
    in_reads = macs / max(in_reuse, 1)
    out_elems = d["B"] * d["K"] * d["OY"] * d["OX"]

    # ---- LOMA-lite temporal-mapping search (two canonical loop orders) -------
    # A) output-stationary: reduction loops innermost; psums stay in registers,
    #    but each MAC consumes a fresh weight (reused only across spatially-
    #    unrolled output dims).
    spatial_out = math.prod(min(unroll.get(x, 1), d[x]) for x in _WEIGHT_REUSE_DIMS)
    w_reads_A = macs / max(spatial_out, 1)
    out_rw_A = out_elems
    # B) weight-stationary: output loops innermost; weights read once from
    #    SRAM, but psums round-trip SRAM once per residual reduction step.
    w_elems = d["K"] * d["C"] * d["FY"] * d["FX"]
    t_red = math.prod(math.ceil(d[x] / unroll.get(x, 1)) for x in _OUTPUT_REDUCE_DIMS)
    w_reads_B = w_elems
    out_rw_B = out_elems * max(1, 2 * t_red - 1)

    candidates = []
    for w_reads, out_rw in ((w_reads_A, out_rw_A), (w_reads_B, out_rw_B)):
        in_bits = in_reads * bits
        # weights resident in the IMC array: no SRAM traffic nor energy
        w_bits = 0.0 if core.core_type == "aimc" else w_reads * bits
        out_bits_ = out_rw * bits
        sram_bits = in_bits + w_bits + out_bits_
        # DATE'22-style stall model
        stall = max(1.0, (sram_bits / max(ideal, 1)) / core.sram_bw_bits_per_cc)
        cycles = ideal * stall * core.latency_overhead
        candidates.append((cycles, sram_bits, in_bits, w_bits, out_bits_))
    cycles, sram_bits, in_bits, w_bits, out_bits_ = min(candidates)

    w_energy = w_bits * core.weight_energy_pj_per_bit
    e_compute = macs * core.mac_energy_pj
    e_act = (in_bits + out_bits_) * core.act_energy_pj_per_bit
    energy = e_compute + e_act + w_energy
    if core.core_type == "aimc":
        util = macs / max(temporal * core.n_pe, 1)  # per array activation
    else:
        util = macs / max(cycles * core.n_pe, 1)
    return CNCost(cycles, ideal, energy, util, sram_bits,
                  {"compute": e_compute, "sram_act": e_act, "sram_w": w_energy})

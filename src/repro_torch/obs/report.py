"""Bottleneck report: where did the schedule's cycles go?

Pure accounting over one recorded `ScheduleResult`: per-core busy
fraction, link-channel and DRAM-port occupancy, and critical-path
attribution — each resource's busy time is a floor on the makespan, and
the largest floor names the resource the schedule is bound by.  When the
caller supplies the analytical `latency_lower_bound` (e.g. from
`repro_torch.core.vectorized.BatchedFitness`), the report also shows the gap
between that bound and the achieved makespan: the slack a better
schedule could still recover.

Everything here is a deterministic function of the result object —
same schedule, byte-identical report text and JSON.

    >>> import numpy as np
    >>> from repro_torch.core.scheduler import ScheduleResult
    >>> res = ScheduleResult(
    ...     latency_cc=10.0, energy_pj=5.0, energy_breakdown={},
    ...     peak_mem_bytes=0.0, act_peak_bytes=0.0,
    ...     core_intervals=[[(0.0, 8.0, 0)], [(2.0, 6.0, 1)]],
    ...     comm_intervals=[(0.0, 3.0, 0, 1, 64)], dram_intervals=[],
    ...     core_busy=np.array([8.0, 4.0]), mem_events=[])
    >>> rep = bottleneck_report(res)
    >>> rep.critical_resource, rep.bound_cc, rep.slack_cc
    ('core0', 8.0, 2.0)
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.core.scheduler import ScheduleResult


@dataclasses.dataclass(frozen=True)
class BottleneckReport:
    """Per-resource occupancy + critical-path attribution of one schedule.

    `floors_cc` maps each resource lane (``core<i>``, ``chan<c>`` or
    ``bus``, ``dram``) to its total busy cycles — each a lower bound on
    the makespan since a lane serializes its work.  `bound_cc` is the
    largest floor (or the analytical `lower_bound_cc` when that is
    tighter), `critical_resource` its lane, and `slack_cc` the headroom
    ``makespan - bound``.

        >>> rep = BottleneckReport(
        ...     makespan_cc=10.0, energy_pj=5.0,
        ...     core_busy_cc=(8.0,), core_busy_frac=(0.8,),
        ...     comm_busy_cc=3.0, dram_busy_cc=0.0,
        ...     floors_cc={"core0": 8.0, "bus": 3.0},
        ...     bound_cc=8.0, lower_bound_cc=None, slack_cc=2.0,
        ...     critical_resource="core0")
        >>> "core0" in rep.to_text()
        True
        >>> json.loads(rep.to_json())["critical_resource"]
        'core0'
    """

    makespan_cc: float
    energy_pj: float
    core_busy_cc: tuple
    core_busy_frac: tuple
    comm_busy_cc: float
    dram_busy_cc: float
    floors_cc: dict
    bound_cc: float
    lower_bound_cc: float | None
    slack_cc: float
    critical_resource: str

    def to_dict(self) -> dict:
        return {
            "makespan_cc": self.makespan_cc,
            "energy_pj": self.energy_pj,
            "core_busy_cc": list(self.core_busy_cc),
            "core_busy_frac": list(self.core_busy_frac),
            "comm_busy_cc": self.comm_busy_cc,
            "dram_busy_cc": self.dram_busy_cc,
            "floors_cc": dict(self.floors_cc),
            "bound_cc": self.bound_cc,
            "lower_bound_cc": self.lower_bound_cc,
            "slack_cc": self.slack_cc,
            "critical_resource": self.critical_resource,
        }

    def to_json(self) -> str:
        """Byte-stable JSON form (sorted keys, pinned separators)."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(", ", ": "))

    def to_text(self) -> str:
        """Fixed-width text rendering for terminals and logs."""
        lines = [f"makespan      {self.makespan_cc:.1f} cc"
                 f"   energy {self.energy_pj:.1f} pJ"]
        if self.lower_bound_cc is not None:
            lines.append(f"lower bound   {self.lower_bound_cc:.1f} cc")
        lines.append(f"bound         {self.bound_cc:.1f} cc"
                     f" ({self.critical_resource})"
                     f"   slack {self.slack_cc:.1f} cc")
        for i, (busy, frac) in enumerate(zip(self.core_busy_cc,
                                             self.core_busy_frac)):
            bar = "#" * int(round(frac * 20))
            lines.append(f"core{i:<3d} {busy:12.1f} cc"
                         f"  {frac:6.1%}  |{bar:<20}|")
        lines.append(f"comm   {self.comm_busy_cc:12.1f} cc")
        lines.append(f"dram   {self.dram_busy_cc:12.1f} cc")
        return "\n".join(lines)


def bottleneck_report(result: ScheduleResult,
                      lower_bound_cc: float | None = None
                      ) -> BottleneckReport:
    """Build the `BottleneckReport` of one recorded schedule.

    Busy fractions divide each lane's occupied cycles by the makespan;
    the critical resource is the lane with the largest occupancy floor.
    Pass `lower_bound_cc` (the analytical bound for this allocation) to
    get slack attribution against it.

        >>> import numpy as np
        >>> from repro_torch.core.scheduler import ScheduleResult
        >>> res = ScheduleResult(
        ...     latency_cc=10.0, energy_pj=5.0, energy_breakdown={},
        ...     peak_mem_bytes=0.0, act_peak_bytes=0.0,
        ...     core_intervals=[[(0.0, 8.0, 0)]],
        ...     comm_intervals=[], dram_intervals=[(0.0, 9.0, "in", 64)],
        ...     core_busy=np.array([8.0]), mem_events=[])
        >>> rep = bottleneck_report(res, lower_bound_cc=6.0)
        >>> rep.critical_resource, rep.floors_cc["dram"]
        ('dram', 9.0)
        >>> rep.core_busy_frac
        (0.8,)
    """
    makespan = float(result.latency_cc)
    denom = max(makespan, 1e-12)
    core_busy = tuple(float(b) for b in result.core_busy)
    core_frac = tuple(b / denom for b in core_busy)

    floors: dict[str, float] = {}
    for i, busy in enumerate(core_busy):
        floors[f"core{i}"] = busy
    comm_busy = float(sum(e - s for (s, e, _u, _v, _b)
                          in result.comm_intervals))
    if result.chan_intervals:
        per_chan: dict[int, float] = {}
        for (s, e, c, _b) in result.chan_intervals:
            per_chan[c] = per_chan.get(c, 0.0) + (e - s)
        for c in sorted(per_chan):
            floors[f"chan{c}"] = per_chan[c]
    elif comm_busy:
        floors["bus"] = comm_busy
    dram_busy = float(sum(e - s for (s, e, _k, _b) in result.dram_intervals))
    if dram_busy:
        floors["dram"] = dram_busy

    critical = max(floors, key=lambda k: (floors[k], k)) if floors else "core0"
    bound = floors.get(critical, 0.0)
    if lower_bound_cc is not None and lower_bound_cc > bound:
        bound, critical = float(lower_bound_cc), "analytical"
    return BottleneckReport(
        makespan_cc=makespan, energy_pj=float(result.energy_pj),
        core_busy_cc=core_busy, core_busy_frac=core_frac,
        comm_busy_cc=comm_busy, dram_busy_cc=dram_busy,
        floors_cc=floors, bound_cc=bound,
        lower_bound_cc=(None if lower_bound_cc is None
                        else float(lower_bound_cc)),
        slack_cc=makespan - bound, critical_resource=critical)

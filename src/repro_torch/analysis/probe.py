"""Perf probe: attribute collective bytes to the port's source locations,
the JAX package's `repro/analysis/probe.py` over a dry run's recorder
(`analysis.hlo.Recorder`).

The reference keys each collective on its HLO `op_name` metadata; the
port's recorder logs the Python source that asked for it (`_where` in
`analysis.hlo`: the model function and the sharding call, or the autograd
function of a backward pass), so the rows are keyed on (kind, source).

    >>> import torch
    >>> from repro_torch.analysis.hlo import Recorder
    >>> from repro_torch.sharding.rules import Mesh, all_gather
    >>> mesh = Mesh.abstract((4,), ("data",), device_type="cpu")
    >>> with Recorder(mesh) as rec:
    ...     y = all_gather(torch.ones(2, 3), mesh, "data")
    >>> rows, a = collective_blame(rec)
    >>> y.shape, rows[0][0], rows[0][1][0], rows[0][2]
    (torch.Size([8, 3]), 72.0, 'all-gather', 1)
"""
from __future__ import annotations

from collections import defaultdict


def collective_blame(recorder, top: int = 15):
    """The `top` (bytes, (kind, source), count, "dtype[shape]") rows of
    the recorder's collectives by wire bytes a device, largest first, and
    the recorder's counts (`HLOAnalysis`)."""
    blame = defaultdict(lambda: [0.0, 0, ""])
    for kind, nbytes, where, shape, dtype in recorder.log:
        row = blame[(kind, where)]
        row[0] += nbytes
        row[1] += 1
        row[2] = f"{dtype}[{','.join(map(str, shape))}]"[:40]
    rows = sorted(((v[0], k, v[1], v[2]) for k, v in blame.items()),
                  reverse=True)
    return rows[:top], recorder.analysis()


def print_blame(recorder, top: int = 15, report=print):
    rows, a = collective_blame(recorder, top)
    report(f"total collective bytes/device: {a.total_collective_bytes:.3e}  "
           f"breakdown: { {k: f'{v:.2e}' for k, v in a.collective_bytes.items()} }")
    report(f"{'bytes':>10s} {'x':>5s} {'kind':18s} source")
    for nbytes, (kind, tail), count, otype in rows:
        report(f"{nbytes:10.3e} {count:5d} {kind:18s} {tail[:90]}")
    return rows, a

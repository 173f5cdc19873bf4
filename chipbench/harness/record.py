"""What a run leaves for the metric readers (`chipbench/metrics/*.py`)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Run:
    kind: str               # "serve" or "train"
    config: dict            # the configuration file
    traffic: dict           # the traffic file
    setup_s: float          # process start to the window's start
    window: tuple           # host clock (s) at the window's start and end
    peak_bytes: int         # torch.cuda.max_memory_allocated at its end
    waves: list = dataclasses.field(default_factory=list)   # serving
    steps: list = dataclasses.field(default_factory=list)   # training
    trace: object = None    # harness.trace.Trace of a traced run
    # over several cards (harness/ranks.py): host seconds of each wave's
    # broadcast of rank 0's go-ahead on this rank, and after the window
    # every rank's busy seconds (peak_bytes is then the fullest card's)
    lockstep_s: list = dataclasses.field(default_factory=list)
    rank_busy_s: list = dataclasses.field(default_factory=list)

    def timed_waves(self) -> list:
        """The waves that ran outside the profiler."""
        return [w for w in self.waves if not w["profiled"]]

    def timed_steps(self) -> list:
        return [s for s in self.steps if not s["profiled"]]

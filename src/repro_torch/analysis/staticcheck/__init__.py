"""Static analysis of the port: the **schedule race detector**
(`repro_torch.analysis.staticcheck.racecheck`), a trace validator proving
resource exclusivity, dependency ordering, segment-barrier monotonicity and
memory-capacity feasibility on a recorded schedule, also reachable as
``ScheduleEngine.schedule(..., validate=True)``.

    >>> issubclass(TraceValidationError, ValueError)
    True
"""
from repro_torch.analysis.staticcheck.racecheck import (
    TraceValidationError,
    validate_trace,
)

__all__ = ["TraceValidationError", "validate_trace"]

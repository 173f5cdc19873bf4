"""Single-point exploration API of the port (`ExplorationSession`)."""
from repro_torch.api.session import ExplorationSession, FifoCache, \
    default_session

__all__ = ["ExplorationSession", "FifoCache", "default_session"]

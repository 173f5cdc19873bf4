"""Serving layer of the port: the batched token engine.

`SlotBatcher` imports eagerly; the token engine (`engine`) is reached as
``repro_torch.serve.engine``.  The closed-loop simulator and its workloads
are ROADMAP queue 1, item 4.
"""
from repro_torch.serve.batching import SlotBatcher

__all__ = ["SlotBatcher"]

"""Slot admission shared by the analytic simulator and the token engine.

Continuous batching is, at its core, slot bookkeeping: a fixed number of
batch slots, FIFO admission into free ones, release on completion.  The
JAX package's analytic simulator (`repro.serve.simulator.simulate`, cycle
domain) and token engine drive this policy, and so does the port's
`repro_torch.serve.engine.ServeEngine.serve` (token-step domain), so the
admission policy the simulator's SLO curves assume is the policy the
port's engine executes.

Deterministic by construction: active requests are kept in admission
order (a list, never a hash-ordered set), and the occupancy invariant
``len(active) <= batch_slots`` is enforced on every admit.
"""
from __future__ import annotations


class SlotBatcher:
    """Fixed-capacity slot pool with FIFO admission-order accounting.

        >>> b = SlotBatcher(2)
        >>> b.admit(0); b.admit(1); b.free_slots()
        0
        >>> b.admit(2)
        Traceback (most recent call last):
            ...
        RuntimeError: admission beyond batch_slots=2
        >>> b.release(0); b.admit(2); b.active()
        [1, 2]
        >>> b.max_active
        2
    """

    def __init__(self, batch_slots: int):
        if batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
        self.batch_slots = int(batch_slots)
        self._active: list[int] = []     # rids, admission order
        self.max_active = 0
        self.n_admitted = 0

    def free_slots(self) -> int:
        return self.batch_slots - len(self._active)

    def active(self) -> list[int]:
        """Active rids in admission order (a copy — safe to iterate while
        releasing)."""
        return list(self._active)

    def admit(self, rid: int) -> None:
        if len(self._active) >= self.batch_slots:
            raise RuntimeError(
                f"admission beyond batch_slots={self.batch_slots}")
        if rid in self._active:
            raise RuntimeError(f"request {rid} already admitted")
        self._active.append(rid)
        self.n_admitted += 1
        self.max_active = max(self.max_active, len(self._active))

    def release(self, rid: int) -> None:
        try:
            self._active.remove(rid)
        except ValueError:
            raise RuntimeError(f"request {rid} is not active") from None

"""KV-cache slot management for continuous batching.

The device cache is a fixed pool of B slots (allocated once, shapes from
models.init_cache); the host-side :class:`SlotAllocator` maps live requests
to slots.  Sequences join/leave the batch independently (per-slot write
positions in the decode step), so a finished request's slot is immediately
reusable — vLLM-style continuous batching at slot granularity.  The slot
table lives in a DataX StateStore database (the paper's platform-managed
state): engine restarts recover the serving session map from it.  Any
object with ``ensure_table(name, columns)`` returning a table with
``scan``/``put``/``delete`` serves as that database.
"""
from __future__ import annotations

import threading
from typing import Any, Protocol


class Database(Protocol):
    """What the allocator needs of a platform database (duck-typed: the
    JAX package's ``repro.core.state.Database`` is one)."""

    def ensure_table(self, name: str, columns: list): ...


class CacheFullError(RuntimeError):
    pass


class SlotAllocator:
    """Thread-safe map request_id -> cache slot."""

    def __init__(self, n_slots: int, db: Database | None = None):
        self.n_slots = n_slots
        self._free = list(range(n_slots - 1, -1, -1))
        self._owner: dict[int, Any] = {}
        self._by_request: dict[Any, int] = {}
        self._lock = threading.Lock()
        self._table = db.ensure_table("kv_slots",
                                      ["request_id", "len"]) if db else None
        if self._table is not None:  # recover session map on restart
            for slot, row in self._table.scan():
                if slot in self._free:
                    self._free.remove(slot)
                self._owner[slot] = row["request_id"]
                self._by_request[row["request_id"]] = slot

    def alloc(self, request_id) -> int:
        with self._lock:
            if not self._free:
                raise CacheFullError(f"all {self.n_slots} KV slots in use")
            slot = self._free.pop()
            self._owner[slot] = request_id
            self._by_request[request_id] = slot
            if self._table is not None:
                self._table.put(slot, {"request_id": request_id, "len": 0})
            return slot

    def free(self, request_id) -> int:
        with self._lock:
            slot = self._by_request.pop(request_id)
            del self._owner[slot]
            self._free.append(slot)
            if self._table is not None:
                self._table.delete(slot)
            return slot

    def slot_of(self, request_id) -> int | None:
        with self._lock:
            return self._by_request.get(request_id)

    def live_slots(self) -> dict:
        with self._lock:
            return dict(self._owner)

    @property
    def n_free(self) -> int:
        with self._lock:
            return len(self._free)

"""Continuous batching scheduler.

Decides, each engine tick, which requests to prefill (admit) and which
slots to decode.  Policy: admit waiting requests whenever slots are free
(prefill-priority, bounded by max_prefill_batch), then decode every live
slot in one lockstep step.  Requests finish on EOS or max_new_tokens and
release their slot immediately — the next waiting request takes it on the
following tick (continuous batching).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any


@dataclasses.dataclass
class Request:
    request_id: Any
    prompt: list                 # token ids
    max_new_tokens: int = 32
    eos_id: int | None = None
    arrived: float = dataclasses.field(default_factory=time.monotonic)
    # filled by the engine:
    slot: int | None = None
    generated: list = dataclasses.field(default_factory=list)
    prefill_done: bool = False
    first_token_at: float | None = None
    finished_at: float | None = None

    @property
    def done(self) -> bool:
        if self.eos_id is not None and self.generated \
                and self.generated[-1] == self.eos_id:
            return True
        return len(self.generated) >= self.max_new_tokens


@dataclasses.dataclass
class Tick:
    admit: list      # requests to prefill this tick
    decode: list     # live requests to decode this tick
    finished: list   # requests that completed last tick (slots released)


class ContinuousBatcher:
    def __init__(self, n_slots: int, max_prefill_per_tick: int = 1):
        self.n_slots = n_slots
        self.max_prefill_per_tick = max_prefill_per_tick
        self.waiting: deque[Request] = deque()
        self.live: dict[Any, Request] = {}
        self.completed: list[Request] = []

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def plan_tick(self, free_slots: int) -> Tick:
        finished = [r for r in self.live.values() if r.done]
        for r in finished:
            r.finished_at = time.monotonic()
            del self.live[r.request_id]
            self.completed.append(r)
        free = free_slots + len(finished)
        admit = []
        while self.waiting and free > 0 and \
                len(admit) < self.max_prefill_per_tick:
            req = self.waiting.popleft()
            admit.append(req)
            free -= 1
        for r in admit:
            self.live[r.request_id] = r
        decode = [r for r in self.live.values() if r.prefill_done]
        return Tick(admit=admit, decode=decode, finished=finished)

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.live

"""ServeEngine — continuous-batching inference on one CUDA card.

Counterpart of ``repro/serve/engine.py``, with the same lifecycle:

  1. plan_tick() — finish EOS/len-capped requests, free slots, admit waiters;
  2. prefill each admitted request (prompt bucketed as the reference does)
     straight into its slot's rows of the KV pool, emit its first token;
  3. one lockstep decode step over ALL live slots (per-slot positions —
     sequences at different lengths decode together);
  4. return finished requests.

PyTorch runs eagerly, so there are no per-bucket compilations to cache;
the cache pool is updated in place where the reference donates buffers to
jitted inserts.  The slot table can persist in a platform database (any
object with ``ensure_table``; see kvcache.py).
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from repro_torch import models
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import transformer as T

from .batcher import ContinuousBatcher, Request
from .kvcache import Database, SlotAllocator


def _bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 2048) * 2048


class ServeEngine:
    def __init__(self, cfg: ModelConfig, run: RunConfig, params: nn.Module,
                 *, n_slots: int = 8, max_seq: int = 512,
                 db: Database | None = None, eos_id: int | None = None,
                 device="cuda"):
        self.device = T.resolve_device(device)
        held = {p.device for p in params.parameters()}
        if held != {self.device}:
            raise ValueError(f"params live on {sorted(map(str, held))}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.run = run
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.batcher = ContinuousBatcher(n_slots)
        self.slots = SlotAllocator(n_slots, db=db)
        self.params = params
        self.cache = models.init_cache(cfg, n_slots, max_seq,
                                       device=self.device)
        self.seq_lens = np.zeros((n_slots,), np.int32)
        self.last_token = np.zeros((n_slots,), np.int32)
        self.last_prefill_logits: torch.Tensor | None = None   # [V] f32
        self.metrics = {"ticks": 0, "prefills": 0, "decode_steps": 0,
                        "tokens_generated": 0, "prefill_s": 0.0,
                        "decode_s": 0.0}

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    # -------------------------------------------------------------- lifecycle
    def submit(self, request_id, prompt: list[int],
               max_new_tokens: int = 32) -> None:
        self.batcher.submit(Request(request_id=request_id, prompt=list(prompt),
                                    max_new_tokens=max_new_tokens,
                                    eos_id=self.eos_id))

    def _do_prefill(self, req: Request) -> None:
        plen = len(req.prompt)
        if self.cfg.family in ("ssm", "hybrid", "moe"):
            # recurrent state / expert capacity would see the padding:
            # exact-length prefill, as the reference (engine.py:117-127)
            bucket = plen
        else:
            # causal attention ignores right-padding (masked by seq_lens)
            bucket = min(_bucket(plen), self.max_seq)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :plen] = req.prompt
        batch = {"tokens": self._tensor(toks),
                 "last_index": self._tensor(np.asarray([plen - 1], np.int32))}
        slot = self.slots.alloc(req.request_id)
        t0 = time.perf_counter()
        try:
            logits, _ = T.prefill_with_cache(self.params, batch, self.cfg,
                                             self.run, self.max_seq,
                                             cache=self.cache, slot=slot)
        except BaseException:
            self.slots.free(req.request_id)
            raise
        first = int(logits[0].argmax())
        self.metrics["prefill_s"] += time.perf_counter() - t0
        self.last_prefill_logits = logits[0]
        req.slot = slot
        req.generated.append(first)
        req.prefill_done = True
        req.first_token_at = time.monotonic()
        self.seq_lens[slot] = plen
        self.last_token[slot] = first
        self.metrics["prefills"] += 1

    def _do_decode(self, live: list[Request]) -> None:
        active = np.zeros((self.n_slots,), bool)
        for req in live:
            active[req.slot] = True
        batch = {
            "tokens": self._tensor(self.last_token[:, None]),
            "seq_lens": self._tensor(self.seq_lens),
            "active": self._tensor(active),
        }
        t0 = time.perf_counter()
        logits, self.cache = models.decode_step(self.params, self.cache,
                                                batch, self.cfg, self.run)
        next_tok = logits.argmax(dim=-1).cpu().numpy()
        self.metrics["decode_s"] += time.perf_counter() - t0
        for req in live:
            s = req.slot
            self.seq_lens[s] += 1
            tok = int(next_tok[s])
            req.generated.append(tok)
            self.last_token[s] = tok
            self.metrics["tokens_generated"] += 1
        self.metrics["decode_steps"] += 1

    def tick(self) -> list[Request]:
        """One engine iteration; returns requests finished this tick."""
        plan = self.batcher.plan_tick(self.slots.n_free)
        for req in plan.finished:
            self.slots.free(req.request_id)
        for req in plan.admit:
            self._do_prefill(req)
        if plan.decode:
            self._do_decode(plan.decode)
        self.metrics["ticks"] += 1
        return plan.finished

    def run_until_idle(self, max_ticks: int = 10_000) -> list[Request]:
        done: list[Request] = []
        for _ in range(max_ticks):
            done.extend(self.tick())
            if self.batcher.idle:
                break
        done.extend(self.tick())  # flush final finishes
        return done

"""Continuous-batching serve loop.

Port of ``repro.serve.scheduler``.  Requests enter a FIFO; the scheduler
admits them into free batch slots, prefills each prompt at batch 1 and
splices its state into the slot, then advances all slots one token per
``step``.  Finished sequences free their slot at once (iteration-level
scheduling).  Batch-level state is the model's decode state, slot-sliced
by ``_slot_index``: a leaf of one dimension is ``[B]`` (``cache_len``),
any other ``[L, B, ...]``.

There is no ``jit``: ``decode_step`` is called directly.  The greedy
argmax runs on the model's device, and each step copies the batch's
next tokens to the host once.  Each request records when its first
token reached the host (``time.perf_counter``), for time to first
token.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models.model import ModelAPI

__all__ = ["DrainStatus", "Request", "ServeConfig", "ContinuousBatcher"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [len] int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the scheduler
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False             # drain hit max_steps first
    t_first: Optional[float] = None     # first token on the host


@dataclasses.dataclass(frozen=True)
class DrainStatus:
    """Outcome of ``run_until_drained``: whether every request finished,
    how many steps ran, and the rids left queued/active on truncation."""

    drained: bool
    steps: int
    unfinished: List[int]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_slots: int = 4
    max_len: int = 256


class ContinuousBatcher:
    def __init__(self, model: ModelAPI, params, cfg: ServeConfig):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * cfg.batch_slots
        self.state = model.init_decode_state(cfg.batch_slots, cfg.max_len)
        self.steps = 0

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        dev = self.model.device
        for i, slot in enumerate(self.slots):
            if slot is not None or not self.queue:
                continue
            req = self.queue.popleft()
            self.slots[i] = req
            # per-slot prefill: run the prompt through a batch-1 prefill
            # and splice its state into slot i
            tokens = torch.as_tensor(np.asarray(req.prompt, np.int32)[None],
                                     device=dev).to(torch.int64)
            state1, logits = self.model.prefill(self.params, tokens,
                                                self.cfg.max_len)
            tok = int(torch.argmax(logits[0]))
            req.t_first = time.perf_counter()
            req.output.append(tok)
            for name, full in self.state.items():
                one = state1[name]
                full[_slot_index(full, i)] = one[_first(one)]

    def step(self) -> None:
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return
        tokens = np.zeros((self.cfg.batch_slots, 1), np.int64)
        for i in active:
            tokens[i, 0] = self.slots[i].output[-1]
        logits, self.state = self.model.decode_step(
            self.params, self.state,
            torch.as_tensor(tokens, device=self.model.device))
        self.steps += 1
        next_tok = torch.argmax(logits, dim=-1).cpu().numpy()
        for i in active:
            req = self.slots[i]
            tok = int(next_tok[i])
            req.output.append(tok)
            if (req.eos_id is not None and tok == req.eos_id) or (
                    len(req.output) >= req.max_new_tokens):
                req.done = True
                self.slots[i] = None  # slot freed for the next admit

    def run_until_drained(self, max_steps: int = 10_000,
                          strict: bool = True) -> DrainStatus:
        """Pump ``step`` until every request finished or ``max_steps``
        decode steps ran.  Every unfinished request is then marked
        ``truncated``: an exception under ``strict`` (the default),
        otherwise a ``DrainStatus`` with ``drained=False`` naming the
        rids."""
        while (self.queue or any(s is not None for s in self.slots)) and \
                self.steps < max_steps:
            self.step()
        unfinished = [r for r in (*self.queue, *self.slots)
                      if r is not None and not r.done]
        for r in unfinished:
            r.truncated = True
        status = DrainStatus(drained=not unfinished, steps=self.steps,
                             unfinished=[r.rid for r in unfinished])
        if strict and not status.drained:
            raise RuntimeError(
                f"run_until_drained truncated at max_steps={max_steps}: "
                f"{len(status.unfinished)} request(s) still queued/active "
                f"(rids {status.unfinished})")
        return status


def _slot_index(arr: torch.Tensor, i: int):
    """Index tuple addressing batch slot i in a stacked state leaf.

    Decode-state leaves are either [B, ...] (cache_len) or [L, B, ...]
    (per-layer state); the batch axis is 0 when ndim is 1, else 1.
    """
    if arr.dim() >= 2:
        return (slice(None), i)
    return (i,)


def _first(arr: torch.Tensor):
    if arr.dim() >= 2:
        return (slice(None), 0)
    return (0,)

"""Continuous-batching serve engine over the learned paged-KV cache — port
of ``src/repro/serving/engine.py``.

Requests are admitted into a fixed number of decode slots; a sequence that
finishes frees its pages (AULID deletes) and its slot is refilled from the
queue.  Prompt processing is incremental decode (prefill == decode steps),
as in the reference.

The port reproduces the reference's behaviour exactly, including a defect
of the reference (ROADMAP Queue 3): a slot with no request keeps decoding
token 0 at a growing position; its page-table row translates to -1, which
becomes physical page 0, so its k/v land in whichever live sequence owns
page 0, and once its position passes ``max_pages_per_seq * page_size`` the
step raises ``IndexError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve
from ..models.model import DenseLM
from .kv_cache import LearnedPageTable, PagePool
from .paged_model import init_page_pool, paged_decode_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 8
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Serves ``model`` on ``device`` (``cuda:0`` unless the caller names
    another; the model must already live there)."""

    def __init__(self, cfg: ModelConfig, model: DenseLM, *, slots: int = 4,
                 page_size: int = 16, n_pages: int = 256,
                 max_pages_per_seq: int = 32, device=None):
        self.device = resolve(device)
        self.cfg = cfg
        self.model = model
        self.page_size = page_size
        self.max_pages = max_pages_per_seq
        self.pool_pages = PagePool(n_pages)
        self.table = LearnedPageTable(self.pool_pages, self.device)
        self.kv = init_page_pool(cfg, n_pages, page_size, self.device)
        self.slots: list[Optional[Request]] = [None] * slots
        self.slot_seq = np.zeros(slots, np.int64)      # seq id per slot
        self.slot_pos = np.zeros(slots, np.int64) - 1  # last written position
        self.queue: list[Request] = []
        self.next_seq = 1                               # seq ids start at 1
        self.steps = 0
        self.completed: list[Request] = []

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for s, cur in enumerate(self.slots):
            if cur is None and self.queue:
                req = self.queue.pop(0)
                self.slots[s] = req
                self.slot_seq[s] = self.next_seq
                self.next_seq += 1
                self.slot_pos[s] = -1

    # -- one engine step -----------------------------------------------------
    def _ensure_pages(self) -> None:
        for s, req in enumerate(self.slots):
            if req is None:
                continue
            pos = int(self.slot_pos[s]) + 1
            lp = pos // self.page_size
            if self.table.translate(int(self.slot_seq[s]), lp) is None:
                self.table.alloc_page(int(self.slot_seq[s]), lp)

    def _tables(self) -> torch.Tensor:
        """(slots, max_pages) int32 physical pages on the device; an absent
        page (-1) becomes page 0, as in the reference."""
        B = len(self.slots)
        seqs = np.repeat(self.slot_seq, self.max_pages)
        lps = np.tile(np.arange(self.max_pages), B)
        phys = self.table.translate_batch(seqs, lps).reshape(B, self.max_pages)
        return phys.clamp(min=0).to(torch.int32)

    def step(self, trace: list | None = None) -> Optional[torch.Tensor]:
        """Admit, allocate, translate, decode one token for every slot.
        Returns the step's logits (slots, V) on the device, or None when no
        slot holds a request.  ``trace`` collects each K6 call
        (``paged_decode_step``'s hook)."""
        self._admit()
        if all(r is None for r in self.slots):
            return None
        self._ensure_pages()
        B = len(self.slots)
        tokens = np.zeros((B, 1), np.int32)
        for s, req in enumerate(self.slots):
            if req is None:
                continue
            t = int(self.slot_pos[s]) + 1
            if t < len(req.prompt):
                tokens[s, 0] = req.prompt[t]
            else:
                tokens[s, 0] = req.out[-1] if req.out else 0
        pos = np.maximum(self.slot_pos + 1, 0)
        tables = self._tables()
        logits, nxt = paged_decode_step(
            self.cfg, self.model, tokens, pos.astype(np.int64), self.kv,
            tables, self.page_size, trace=trace)
        nxt = nxt.cpu().numpy()
        self.slot_pos = pos
        self.steps += 1
        for s, req in enumerate(self.slots):
            if req is None:
                continue
            t = int(pos[s])
            if t >= len(req.prompt) - 1:
                req.out.append(int(nxt[s]))
            if len(req.out) >= req.max_new or t + 1 >= self.max_pages * self.page_size:
                req.done = True
                self.completed.append(req)
                self.table.free_seq(int(self.slot_seq[s]))
                self.slots[s] = None
        return logits

    def run(self, max_steps: int = 200) -> list[Request]:
        while (self.queue or any(r is not None for r in self.slots)) \
                and self.steps < max_steps:
            self.step()
        return self.completed

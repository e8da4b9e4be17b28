"""Iteration-level (continuous) batching scheduler — Orca (Yu et al.,
OSDI 2022) semantics over a fixed set of decode slots.

Counterpart of the JAX package's ``serve/scheduler.py`` with FIFO
admission. The engine calls :meth:`Scheduler.admit` between decode
steps; requests join and leave the running batch at token granularity.
States: WAITING -> PREFILL (chunked prompt ingestion) -> DECODE (one
token per step) -> FINISHED. Preemption when the KV pool runs dry is
vLLM-style recompute: the youngest running request releases its blocks
and rejoins the queue front with ``prompt + generated`` as its prompt,
so preemption changes latency, never tokens (a sampled request's draws
depend on its seed and token index only).

Not ported yet: the pluggable admission policies, swap-based
preemption, prefix-cache admission and speculative lookahead.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.paged_kv import (
    BlockManager,
    PoolExhausted,
)

WAITING, PREFILL, DECODE, FINISHED = "waiting", "prefill", "decode", "finished"

_rid = itertools.count()


@dataclass
class Request:
    """One generation request: ``prompt`` token ids [P]; the engine
    appends generated ids to ``output``. Times are engine-side
    ``perf_counter`` stamps (None until reached).

    Sampling is per request: ``temperature == 0`` (the default) is greedy,
    the mode whose tokens equal ``generate_causal``'s; ``temperature > 0``
    samples after optional top-k / top-p truncation, seeded by ``seed``:
    the n-th token's draw is a function of (seed, n) alone, so a stream
    is the same across recompute preemption."""

    prompt: np.ndarray
    max_new_tokens: int
    rid: int = field(default_factory=lambda: next(_rid))
    output: list = field(default_factory=list)
    state: str = WAITING
    submit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    preemptions: int = 0
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    seed: int = 0
    # recompute preemption folds generated tokens into the prompt; this
    # keeps the original prompt length for output accounting
    orig_prompt_len: int = -1

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.orig_prompt_len < 0:
            self.orig_prompt_len = len(self.prompt)
        if len(self.prompt) < 1:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not 0.0 <= self.top_p <= 1.0:
            raise ValueError("top_p must be in [0, 1]")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")

    @property
    def sampled(self) -> bool:
        return self.temperature > 0

    @property
    def ttft_s(self) -> Optional[float]:
        if self.submit_t is None or self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t


class Slot:
    """One decode slot: its block table, resident context and prefill
    progress (over the chunk-padded prompt)."""

    def __init__(self, index: int):
        self.index = index
        self.request: Optional[Request] = None
        self.table: list[int] = []
        self.context_len = 0
        self.prefill_pos = 0
        self.admit_seq = -1          # admission order, for victim choice

    @property
    def free(self) -> bool:
        return self.request is None

    def clear(self) -> None:
        self.request = None
        self.table = []
        self.context_len = 0
        self.prefill_pos = 0
        self.admit_seq = -1


class Scheduler:
    """FIFO admission into ``num_slots`` decode slots, chunked prefill
    under a token budget, and recompute preemption. The engine owns the
    clock and the device; this class owns who runs."""

    def __init__(self, num_slots: int, blocks: BlockManager,
                 prefill_chunk: int, max_model_len: int):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if max_model_len % blocks.block_size:
            raise ValueError(
                f"max_model_len {max_model_len} must be a multiple of "
                f"block_size {blocks.block_size}")
        if max_model_len % prefill_chunk:
            # keeps every padded prompt within max_model_len (the block
            # tables are sized for it)
            raise ValueError(
                f"max_model_len {max_model_len} must be a multiple of "
                f"prefill_chunk {prefill_chunk}")
        self.slots = [Slot(i) for i in range(num_slots)]
        self.blocks = blocks
        self.prefill_chunk = int(prefill_chunk)
        self.max_model_len = int(max_model_len)
        self.waiting: list[Request] = []
        self._admit_seq = itertools.count()
        self._prefill_rr = 0
        self.n_preemptions = 0

    # -- queue side ----------------------------------------------------------

    def submit(self, request: Request) -> None:
        total = len(request.prompt) + request.max_new_tokens
        if total > self.max_model_len:
            raise ValueError(
                f"request {request.rid}: prompt {len(request.prompt)} + "
                f"max_new_tokens {request.max_new_tokens} exceeds "
                f"max_model_len {self.max_model_len}")
        # worst-case lifetime block need: the padded prompt, the full
        # context, or a preemption at max_new - 1 folding the generation
        # into a prompt padded to a chunk multiple again. A request that
        # can never fit the whole pool would livelock the queue head.
        worst = max(self.padded_prompt_len(request), total,
                    -(-(total - 1) // self.prefill_chunk) * self.prefill_chunk)
        need = self.blocks.blocks_for(worst)
        capacity = self.blocks.num_blocks - 1
        if need > capacity:
            raise ValueError(
                f"request {request.rid} can need {need} KV blocks "
                f"(context {worst} at block_size "
                f"{self.blocks.block_size}) but the pool only holds "
                f"{capacity}: grow num_blocks or shrink the request")
        self.waiting.append(request)

    def has_work(self) -> bool:
        return bool(self.waiting) or any(not s.free for s in self.slots)

    # -- admission -----------------------------------------------------------

    def padded_prompt_len(self, request: Request) -> int:
        """Prompt width after right-padding to a prefill-chunk multiple."""
        p = len(request.prompt)
        return p + (-p % self.prefill_chunk)

    def admit(self) -> list[Slot]:
        """Move waiting requests into free slots, in order, while the
        pool can reserve each one's whole padded prompt (so prefill never
        dies mid-prompt; the pad tail is trimmed at prefill completion).
        Returns the slots admitted."""
        admitted = []
        for slot in self.slots:
            if not self.waiting:
                break
            if not slot.free:
                continue
            req = self.waiting[0]
            need = self.blocks.blocks_for(self.padded_prompt_len(req))
            if not self.blocks.can_allocate(need):
                break                       # FIFO: no queue-jumping
            self.waiting.pop(0)
            slot.request = req
            slot.table = self.blocks.allocate(need)
            slot.context_len = 0
            slot.prefill_pos = 0
            slot.admit_seq = next(self._admit_seq)
            req.state = PREFILL
            admitted.append(slot)
        return admitted

    # -- prefill -------------------------------------------------------------

    def next_prefill_slots(self, max_n: int) -> list[Slot]:
        """Up to ``max_n`` prefill-state slots, round-robin from where the
        last call stopped, so no prefilling request starves."""
        n = len(self.slots)
        out: list[Slot] = []
        for k in range(n):
            if len(out) >= max_n:
                break
            slot = self.slots[(self._prefill_rr + k) % n]
            if slot.request is not None and slot.request.state == PREFILL:
                out.append(slot)
        if out:
            self._prefill_rr = (out[-1].index + 1) % n
        return out

    def prefill_token_budget(self, n_active_decode: int) -> int:
        """The iteration's prefill budget in tokens: one chunk with a full
        decode batch (bounding the decode stall a long prompt injects),
        plus one chunk per idle decode slot."""
        idle = max(1, len(self.slots) - n_active_decode)
        return self.prefill_chunk * idle

    def finish_prefill(self, slot: Slot) -> None:
        """Prefill consumed the padded prompt: context becomes the real
        prompt length, the pad tail's blocks return to the pool, and the
        slot starts decoding."""
        slot.context_len = len(slot.request.prompt)
        self.blocks.trim(slot.table, slot.context_len)
        slot.request.state = DECODE

    # -- decode-side capacity ------------------------------------------------

    def decode_slots(self) -> list[Slot]:
        return [s for s in self.slots
                if s.request is not None and s.request.state == DECODE]

    def ensure_decode_capacity(self) -> list[Request]:
        """Make every DECODE slot own a block for the position the next
        step writes (``context_len``), preempting youngest-first when the
        pool runs dry. Returns the requests preempted."""
        preempted = []
        while True:
            ds = self.decode_slots()
            if not ds:
                return preempted
            try:
                for slot in ds:
                    self.blocks.grow(slot.table, slot.context_len + 1)
                return preempted
            except PoolExhausted:
                victim = max(ds, key=lambda s: s.admit_seq)
                preempted.append(victim.request)
                self.preempt(victim)

    def preempt(self, slot: Slot) -> None:
        """Recompute preemption: fold the generated tokens into the
        prompt, release every block, and rejoin the queue front."""
        req = slot.request
        req.prompt = np.concatenate([req.prompt,
                                     np.asarray(req.output, np.int32)])
        req.output = []
        req.state = WAITING
        req.preemptions += 1
        self.n_preemptions += 1
        self.blocks.release(slot.table)
        slot.clear()
        self.waiting.insert(0, req)

    def finish(self, slot: Slot) -> Request:
        """Request complete: release its table and free the slot."""
        req = slot.request
        req.state = FINISHED
        self.blocks.release(slot.table)
        slot.clear()
        return req

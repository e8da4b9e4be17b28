"""Paged KV-cache bookkeeping: a fixed population of fixed-size blocks
handed to requests as their context grows (vLLM, Kwon et al. 2023).

Counterpart of the JAX package's ``serve/paged_kv.py`` (``PoolExhausted``
and the allocator part of ``BlockManager``). The device side is the
per-layer pools ``[num_blocks, block_size, heads, head_dim]``; all
allocation policy lives here in plain Python. Block 0 is the reserved
null block: inactive decode slots scatter their discarded writes there,
so every step keeps one shape. A request holds ``ceil(context /
block_size)`` blocks, so memory follows the tokens actually resident.

Not ported yet: the prefix cache with copy-on-write, the host tier and
block-set transport.
"""

from __future__ import annotations

from typing import Sequence


class PoolExhausted(Exception):
    """Raised by :meth:`BlockManager.allocate` when the pool cannot
    satisfy a request — the scheduler catches it and preempts."""


class BlockManager:
    """Free-list allocator over ``num_blocks`` blocks of ``block_size``
    token slots each. Block 0 is the reserved null block and is never
    handed out."""

    def __init__(self, num_blocks: int, block_size: int,
                 token_bytes: int = 0):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (block 0 is the reserved "
                             f"null block), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # bytes one resident token costs across every pool
        self.token_bytes = int(token_bytes)
        # LIFO free list: recently freed blocks are reused first
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._held = [False] * self.num_blocks
        self.peak_used = 0

    # -- capacity arithmetic -------------------------------------------------

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` context tokens."""
        return -(-max(int(n_tokens), 0) // self.block_size)

    @property
    def block_bytes(self) -> int:
        return self.block_size * self.token_bytes

    @property
    def pool_bytes(self) -> int:
        return self.num_blocks * self.block_bytes

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_blocks - 1 - len(self._free)

    def can_allocate(self, n_blocks: int) -> bool:
        return n_blocks <= len(self._free)

    def utilization(self) -> float:
        """Fraction of allocatable blocks currently held by requests."""
        return self.num_used / max(self.num_blocks - 1, 1)

    def fragmentation(self, context_lens) -> float:
        """Fraction of held token slots that are padding inside
        partially filled last blocks."""
        held_tokens = sum(self.blocks_for(c) * self.block_size
                          for c in context_lens)
        if held_tokens == 0:
            return 0.0
        return 1.0 - sum(int(c) for c in context_lens) / held_tokens

    # -- alloc/release -------------------------------------------------------

    def allocate(self, n_blocks: int) -> list[int]:
        """Pop ``n_blocks`` block ids; raises :class:`PoolExhausted`
        (allocating nothing) when short."""
        if not self.can_allocate(n_blocks):
            raise PoolExhausted(
                f"need {n_blocks} blocks, {len(self._free)} free "
                f"(pool {self.num_blocks - 1} allocatable)")
        out = [self._free.pop() for _ in range(n_blocks)]
        for b in out:
            self._held[b] = True
        self.peak_used = max(self.peak_used, self.num_used)
        return out

    def grow(self, table: list[int], n_tokens: int) -> list[int]:
        """Extend ``table`` to cover ``n_tokens`` of context; returns the
        new ids. All-or-nothing on :class:`PoolExhausted`."""
        need = self.blocks_for(n_tokens) - len(table)
        if need <= 0:
            return []
        fresh = self.allocate(need)
        table.extend(fresh)
        return fresh

    def trim(self, table: list[int], n_tokens: int) -> None:
        """Release table blocks beyond what ``n_tokens`` needs (the pad
        tail of a chunk-padded prompt)."""
        keep = self.blocks_for(n_tokens)
        while len(table) > keep:
            self.release([table.pop()])

    def release(self, blocks: Sequence[int]) -> None:
        """Return blocks to the free list. Releasing a block outside the
        pool or one not held raises (the double-free guard)."""
        for b in blocks:
            if not 1 <= b < self.num_blocks:
                raise ValueError(f"releasing block {b} outside the pool")
            if not self._held[b]:
                raise ValueError(f"double free of block {b} (not held "
                                 "by any table)")
            self._held[b] = False
            self._free.append(b)

    #: the JAX package's name for :meth:`release`
    free = release

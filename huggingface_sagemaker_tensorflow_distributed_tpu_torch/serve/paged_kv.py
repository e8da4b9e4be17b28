"""Paged KV-cache bookkeeping: a fixed population of fixed-size blocks
handed to requests as their context grows (vLLM, Kwon et al. 2023), with
block-level prefix sharing and a host-RAM tier under the device pool.

Counterpart of the JAX package's ``serve/paged_kv.py``. The device side is
the per-layer pools ``[num_blocks, block_size, heads, head_dim]``; all
allocation policy lives in :class:`BlockManager`, plain Python:

- block 0 is the reserved null block: inactive decode slots scatter
  their discarded writes there, so every step keeps one shape;
- a request holds ``ceil(context / block_size)`` blocks;
- every block carries a refcount, and full ``block_size``-aligned prompt
  chunks are indexed by the rolling chain of :func:`prefix_chain_keys`
  (the same ``_CHAIN_ROOT`` and ``hash((h, chunk))`` chain as the JAX
  package, so the keys are equal value for value), so identical prompt
  prefixes map onto the same physical blocks. :meth:`BlockManager.
  match_prefix` increfs the hits, :meth:`~BlockManager.register_prefix`
  publishes a request's full blocks (read-only from then on), a zero-ref
  registered block parks in an LRU until pool pressure evicts it, and
  :meth:`~BlockManager.privatize` is copy-on-write (the caller applies the
  returned ``(src, dst)`` device copies to every pool);
- the host tier: :func:`extract_blocks` / :func:`insert_blocks` move a
  set of blocks, every pool at once (int8 values with their fp32 scale
  pools, and a draft model's pools), between the card and host tensors
  as a :class:`BlockSet`. Swap preemption extracts a victim's blocks and
  restores them at re-admission; prefix demotion spills a cached block's
  payload before eviction, keyed by its chain key, and a later
  :meth:`~BlockManager.peek_hosted` match revives it. Conservation:
  ``num_free + num_used + num_cached + num_hosted == num_blocks - 1``.

The manager itself stays payload-agnostic (payloads are opaque objects
with an ``nbytes``); only the extract/insert helpers touch tensors.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional, Sequence

import torch

#: chain seed for block 0's key (any fixed odd 64-bit constant)
_CHAIN_ROOT = 0x9E3779B97F4A7C15


def prefix_chain_keys(tokens, block_size: int):
    """Yield ``(chain_key, chunk_tokens)`` per FULL ``block_size``-sized
    chunk of ``tokens``, lazily — a consumer that stops at the first
    index miss never hashes the rest of the prompt. Key N hashes
    (key N-1, chunk N), so a key commits to the whole token prefix
    through its chunk.

    This is THE prefix fingerprint of the serving stack, shared by two
    consumers on purpose: :meth:`BlockManager.chain_keys` builds the
    block-level prefix-cache index from it, and the multi-replica
    router (the JAX package's ``serve/router.py``) builds its replica-affinity
    index from the SAME chain values — so "the replica holding this
    prompt's longest cached prefix" and "the blocks this prompt would
    hit" are answers to one question asked at two granularities, and
    the two indexes can never disagree about what counts as a shared
    prefix. The chain value is a pure function of the tokens (no block
    ids, no engine state), which is what lets a router-level entry
    outlive any replica's physical blocks."""
    bs = int(block_size)
    h = _CHAIN_ROOT
    for i in range(len(tokens) // bs):
        chunk = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
        h = hash((h, chunk))
        yield h, chunk


class CachedBlock(NamedTuple):
    """One prefix-index entry: the physical block plus the exact chunk
    tokens and parent chain key the lookup re-verifies (collision
    safety — see module docstring)."""

    block: int
    parent: int
    chunk: tuple


class HostedBlock(NamedTuple):
    """One host-tier entry: the spilled payload (opaque — the engine
    stores a :class:`BlockSet`; tests store anything with ``nbytes``)
    plus the parent chain key and exact chunk tokens revival
    re-verifies, mirroring :class:`CachedBlock`'s collision safety."""

    parent: int
    chunk: tuple
    payload: object
    nbytes: int


class PoolExhausted(Exception):
    """Raised by :meth:`BlockManager.allocate` when the pool cannot
    satisfy a request — the scheduler catches it and preempts."""


class BlockSet(NamedTuple):
    """Host-RAM serialization of a set of KV blocks: one stacked CPU
    tensor per device pool (shape ``[n_blocks, block_size, H, D]``, the
    pool's own dtype, so fp32/bf16/int8 round-trip bitwise; pinned when
    the pools live on the card), plus the draft pools' tensors for a
    speculative engine (the draft rides the same block tables, so its KV
    travels with the target's). Built by :func:`extract_blocks`, consumed
    by :func:`insert_blocks`; the payload holds no engine state, so a
    same-geometry engine accepts it bitwise."""

    payloads: tuple
    draft_payloads: Optional[tuple]

    @property
    def signature(self) -> tuple:
        """Logical pool geometry the set was extracted from — per-pool
        ``(block shape, dtype)``, target then draft. Sets transplant
        only between engines whose pools report the same signature
        (sharding excluded: shapes here are the assembled host
        shapes)."""
        def sig(ps):
            # dim 0 is the set's block count — geometry is the rest
            return tuple((tuple(int(d) for d in p.shape[1:]),
                          str(p.dtype).replace("torch.", "")) for p in ps)
        return (sig(self.payloads),
                sig(self.draft_payloads)
                if self.draft_payloads is not None else None)

    @property
    def n_blocks(self) -> int:
        """How many blocks this set carries."""
        return int(self.payloads[0].shape[0]) if self.payloads else 0

    @property
    def nbytes(self) -> int:
        """Host bytes the set occupies (target + draft pools)."""
        n = sum(p.numel() * p.element_size() for p in self.payloads)
        if self.draft_payloads is not None:
            n += sum(p.numel() * p.element_size()
                     for p in self.draft_payloads)
        return n


def _copy_out(pools, idx_by_device) -> tuple:
    """Each pool's rows ``idx`` as host tensors (pinned when the pools
    live on the card; every copy queued before one wait)."""
    out = []
    for p in pools:
        rows = p.index_select(0, idx_by_device[p.device])
        if p.device.type == "cpu":
            out.append(rows)
            continue
        host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        host.copy_(rows, non_blocking=True)
        out.append(host)
    return tuple(out)


def _index_for(pools, ids) -> dict:
    idx = torch.as_tensor(list(ids), dtype=torch.long)
    return {dev: idx.to(dev) for dev in {p.device for p in pools}}


def _wait_for(pools) -> None:
    for dev in {p.device for p in pools if p.device.type == "cuda"}:
        torch.cuda.current_stream(dev).synchronize()


def extract_blocks(pools, ids: Sequence[int], d_pools=None) -> BlockSet:
    """Serialize blocks ``ids`` out of the device ``pools`` (and the
    draft's ``d_pools`` when given) into one host-side :class:`BlockSet`.
    Every pool travels at once (int8 values and their fp32 scale pools
    are ordinary pool entries, so a block's scales never part from its
    values): one ``index_select`` per pool, every device-to-host copy
    queued, then one wait. This copy is the swap transfer itself."""
    return extract_block_sets(pools, [ids], d_pools)[0]


def extract_block_sets(pools, id_lists: Sequence[Sequence[int]],
                       d_pools=None) -> list:
    """One :class:`BlockSet` per inner id list, with one wait for the
    whole cohort; each equals its own :func:`extract_blocks`."""
    if not id_lists:
        return []
    out = []
    for ids in id_lists:
        if not ids:
            out.append(BlockSet((), None if d_pools is None else ()))
            continue
        payloads = _copy_out(pools, _index_for(pools, ids))
        draft = (None if d_pools is None
                 else _copy_out(d_pools, _index_for(d_pools, ids)))
        out.append(BlockSet(payloads, draft))
    _wait_for(list(pools) + list(d_pools or []))
    return out


def insert_blocks(pools, block_set: BlockSet, ids: Sequence[int],
                  d_pools=None):
    """Scatter a :class:`BlockSet` into freshly allocated blocks ``ids``
    (``len(ids) == block_set.n_blocks``) of every pool, in place; returns
    ``(pools, d_pools)``. Bitwise: the payload lands as it was read,
    scales included. The host-to-device copies are queued on the pools'
    stream, before any later dispatch that reads the blocks."""
    if len(ids) != block_set.n_blocks:
        raise ValueError(
            f"inserting {block_set.n_blocks} extracted blocks into "
            f"{len(ids)} target ids")
    if (d_pools is None) != (block_set.draft_payloads is None):
        raise ValueError(
            "draft pools and draft payloads must be given together "
            "(a speculative engine's draft KV rides the same tables)")
    if not ids:
        return pools, d_pools
    for ps, payloads in ((pools, block_set.payloads),
                         (d_pools, block_set.draft_payloads)):
        if ps is None:
            continue
        idx = _index_for(ps, ids)
        for p, payload in zip(ps, payloads):
            p.index_copy_(0, idx[p.device],
                          payload.to(p.device, non_blocking=True))
    return pools, d_pools


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
        # bytes one resident token costs across every pool this manager
        # allocates for (int8 KV halves it vs fp; the fp32 scale planes
        # ride along) — the KV-element-size parameterization that lets
        # capacity be reasoned about (and pools be sized) in BYTES:
        # ``ServeEngine(kv_pool_bytes=...)`` divides a memory budget by
        # ``block_bytes``, so int8 pools hold ~2x the blocks — and
        # admit ~2x the requests — of fp pools on the same budget.
        self.token_bytes = int(token_bytes)
        # LIFO free list: recently-freed (cache-warm) blocks are reused
        # first; block 0 excluded for good
        self._free = list(range(self.num_blocks - 1, 0, -1))
        # per-block refcount: 0 = free or cached, >= 1 = held by that
        # many block tables (prefix sharing makes > 1 possible)
        self._ref = [0] * self.num_blocks
        self._used = 0
        # prefix cache: chain key -> CachedBlock, the reverse block ->
        # key map, and the LRU of zero-ref registered blocks (oldest
        # first — the eviction order under pool pressure)
        self._index: dict[int, CachedBlock] = {}
        self._block_key: dict[int, int] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # sharing accounting: how many block tables hold a ref BEYOND
        # the first (the allocation the cache deduplicates), peak
        # count of distinct ref>=2 blocks, COW copies performed, and
        # decode reads served out of shared blocks
        self._extra_refs = 0
        self._shared_blocks = 0      # distinct blocks at ref >= 2, live
        self.peak_shared_blocks = 0
        self.peak_blocks_saved = 0
        self.cow_copies = 0
        self.prefix_evictions = 0
        self._shared_read_tokens = 0
        self.peak_used = 0
        # host-RAM spill tier: the spill hook (installed by
        # the engine — block id -> opaque payload with an ``nbytes``),
        # the byte budget shared by demoted payloads and swap
        # reservations, the DEMOTED device blocks (still resident and
        # matchable, but reclaimable without data loss — their host
        # copy exists), and the host payload store keyed by chain key
        # (LRU for budget eviction). Payloads are content-addressed by
        # the chain key — a chain key's KV is a pure function of its
        # token prefix — so an entry stays valid across any number of
        # evict/revive cycles of its physical blocks.
        self._spill = None
        self.host_budget: Optional[int] = None
        self._hosted: "OrderedDict[int, None]" = OrderedDict()
        self._host_payloads: "OrderedDict[int, HostedBlock]" = OrderedDict()
        # chain keys an in-flight admission matched and is about to
        # revive: budget eviction must not take them mid-reservation
        # (the reservation's own allocations can spill-demote evicted
        # cached blocks, and without the pin that demotion could push
        # the just-matched oldest payloads out of the budget window
        # between peek_hosted and revive_hosted)
        self._host_pinned: set = set()
        self._host_bytes = 0         # demote-tier payload bytes
        self._swap_bytes_held = 0    # engine swap reservations
        self.host_tier_hits = 0      # blocks revived from host payloads
        self.host_tier_lookups = 0   # host-tier probes at admission
        self.prefix_demotions = 0    # fresh payload spills performed
        self.host_evictions = 0      # payloads dropped by budget pressure
        # bucket-padded READ waste (decode-side, orthogonal to the
        # allocation fragmentation below): latched by note_gather()
        self.peak_gather_waste = 0.0
        self._gather_read_tokens = 0
        self._gather_useful_tokens = 0
        # width-(k+1) verify-window padding (speculative decode),
        # counted SEPARATELY from bucket padding: latched by
        # note_verify()
        self.peak_verify_waste = 0.0
        self._verify_window_tokens = 0
        self._verify_useful_tokens = 0

    # -- capacity arithmetic -------------------------------------------------

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` context tokens."""
        return -(-max(int(n_tokens), 0) // self.block_size)

    @property
    def block_bytes(self) -> int:
        """Pool bytes one block occupies (0 when the manager was built
        without a ``token_bytes`` figure)."""
        return self.block_size * self.token_bytes

    def bytes_for(self, n_tokens: int) -> int:
        """Pool bytes ``n_tokens`` of resident context occupies
        (block-granular — the allocation, not the useful payload)."""
        return self.blocks_for(n_tokens) * self.block_bytes

    @property
    def pool_bytes(self) -> int:
        """Total pool footprint in ``token_bytes`` terms (0 when built
        without a ``token_bytes`` figure)."""
        return self.num_blocks * self.block_bytes

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        """Blocks held by at least one block table (refcount >= 1)."""
        return self._used

    @property
    def num_cached(self) -> int:
        """Zero-ref registered blocks parked in the reuse LRU — free
        CAPACITY (evictable on demand) that is still a prefix-cache
        hit until reclaimed."""
        return len(self._lru)

    @property
    def num_hosted(self) -> int:
        """Demoted blocks: zero-ref registered blocks whose payload
        was written back to the host tier while the device copy stays
        resident and matchable — free CAPACITY like the cached LRU,
        but reclaimable WITHOUT data loss (the host copy serves later
        revivals). Conservation: ``num_free + num_used + num_cached +
        num_hosted == num_blocks - 1`` always."""
        return len(self._hosted)

    @property
    def hosted_bytes(self) -> int:
        """Host bytes the spill tier currently holds (demoted payloads
        plus the engine's swap reservations — one budget)."""
        return self._host_bytes + self._swap_bytes_held

    def can_allocate(self, n_blocks: int) -> bool:
        """Cached LRU blocks count as allocatable capacity: they are
        evicted (oldest first) the moment a real allocation needs
        them. Demoted blocks likewise — reclaimed FIRST, since their
        host copy makes the eviction lossless."""
        return n_blocks <= (len(self._free) + len(self._lru)
                            + len(self._hosted))

    def utilization(self) -> float:
        """Fraction of allocatable blocks currently held by requests."""
        return self.num_used / max(self.num_blocks - 1, 1)

    def fragmentation(self, context_lens) -> float:
        """Fraction of HELD token slots that are padding inside
        partially-filled last blocks — the paged design's only waste
        (≤ ``(block_size - 1) / block_size`` per request; a contiguous
        ``max_len`` cache wastes ``1 - context/max_len`` instead)."""
        held_tokens = sum(self.blocks_for(c) * self.block_size
                          for c in context_lens)
        if held_tokens == 0:
            return 0.0
        used_tokens = sum(int(c) for c in context_lens)
        return 1.0 - used_tokens / held_tokens

    def note_gather(self, context_lens, width: int) -> float:
        """Record one decode step's bucket-padded KV READ: the gather
        materializes ``width`` token slots per ACTIVE slot while only
        that slot's context is useful, so the step's read waste is
        ``1 - sum(context) / (slots * width)``. This is the decode-side
        counterpart of :meth:`fragmentation` (which accounts allocation
        padding): bucketing exists precisely to shrink it, and the
        engine surfaces both the PEAK (``peak_gather_waste``, latched
        here) and the token-weighted run mean (:meth:`gather_waste`) in
        its ``serve`` report event and the bench detail line. Returns
        the step's waste fraction (0.0 for an empty step)."""
        read = len(context_lens) * int(width)
        if read == 0:
            return 0.0
        useful = sum(min(int(c), int(width)) for c in context_lens)
        waste = 1.0 - useful / read
        self.peak_gather_waste = max(self.peak_gather_waste, waste)
        self._gather_read_tokens += read
        self._gather_useful_tokens += useful
        return waste

    def gather_waste(self) -> float:
        """Token-weighted mean bucket-padded read waste across every
        :meth:`note_gather`-recorded decode step (0.0 before any)."""
        if self._gather_read_tokens == 0:
            return 0.0
        return 1.0 - self._gather_useful_tokens / self._gather_read_tokens

    def note_verify(self, committed, window: int) -> float:
        """Record one speculative VERIFY dispatch's window padding: each
        active slot computes ``window`` (= k+1) query positions but only
        its ``committed`` tokens (accepted prefix + bonus, post EOS /
        budget truncation) were useful — the rejected tail is the
        width-(k+1) analogue of bucket padding, and it is accounted
        SEPARATELY from :meth:`note_gather` (which this dispatch also
        feeds, for its KV read) so the serve report can tell "we read
        too wide" from "we speculated too deep". Returns the dispatch's
        waste fraction (0.0 for an empty step)."""
        total = len(committed) * int(window)
        if total == 0:
            return 0.0
        useful = sum(min(int(c), int(window)) for c in committed)
        waste = 1.0 - useful / total
        self.peak_verify_waste = max(self.peak_verify_waste, waste)
        self._verify_window_tokens += total
        self._verify_useful_tokens += useful
        return waste

    def verify_waste(self) -> float:
        """Token-weighted mean verify-window waste across every
        :meth:`note_verify`-recorded dispatch (0.0 before any)."""
        if self._verify_window_tokens == 0:
            return 0.0
        return 1.0 - self._verify_useful_tokens / self._verify_window_tokens

    # -- alloc/release -------------------------------------------------------

    def allocate(self, n_blocks: int) -> list[int]:
        """Pop ``n_blocks`` physical block ids (each handed out at
        refcount 1); raises :class:`PoolExhausted` (allocating nothing)
        when short. The free list is consumed first; zero-ref cached
        blocks are evicted from the LRU — oldest first, unpublishing
        their prefix-index entries — only once the free list runs
        dry."""
        if not self.can_allocate(n_blocks):
            raise PoolExhausted(
                f"need {n_blocks} blocks, {len(self._free)} free + "
                f"{len(self._lru)} cached + {len(self._hosted)} hosted "
                f"(pool {self.num_blocks - 1} allocatable)")
        out = []
        for _ in range(n_blocks):
            if not self._free:
                self._reclaim_one()
            b = self._free.pop()
            self._ref[b] = 1
            out.append(b)
        self._used += n_blocks
        self.peak_used = max(self.peak_used, self._used)
        return out

    def _reclaim_one(self) -> None:
        """Put one reclaimable block on the free list. Demoted blocks
        go first (lossless — the host copy keeps serving revivals),
        then the cached LRU's oldest (spilled host-side on the way out
        when a spill hook is installed — "demote before true
        eviction")."""
        if self._hosted:
            b, _ = self._hosted.popitem(last=False)
            key = self._block_key.pop(b)
            del self._index[key]
            self.prefix_evictions += 1
            self._free.append(b)
            return
        self._evict_cached()

    def _evict_cached(self) -> None:
        """Reclaim the least-recently-released cached block: drop its
        index entry (future lookups of that prefix miss at the DEVICE
        level from here on) and put the block on the free list. With a
        spill hook installed the payload is written back to the host
        tier first — budget permitting — so the eviction only demotes
        the prefix instead of forgetting it."""
        b, _ = self._lru.popitem(last=False)
        key = self._block_key.pop(b)
        entry = self._index.pop(key)
        if self._spill is not None:
            if key in self._host_payloads:
                # content-addressed: an identical payload is already
                # resident (a revived block re-cooling) — no new copy
                self._host_payloads.move_to_end(key)
            else:
                payload = self._spill(b)
                nbytes = int(getattr(payload, "nbytes", 0))
                if self._host_admit(nbytes):
                    self._host_payloads[key] = HostedBlock(
                        entry.parent, entry.chunk, payload, nbytes)
                    self._host_bytes += nbytes
                    self.prefix_demotions += 1
        self.prefix_evictions += 1
        self._free.append(b)

    def grow(self, table: list[int], n_tokens: int) -> list[int]:
        """Extend ``table`` (a request's block table) to cover
        ``n_tokens`` of context; returns the newly-allocated ids (empty
        when the table already covers it). All-or-nothing on
        :class:`PoolExhausted`."""
        need = self.blocks_for(n_tokens) - len(table)
        if need <= 0:
            return []
        fresh = self.allocate(need)
        table.extend(fresh)
        return fresh

    def trim(self, table: list[int], n_tokens: int) -> None:
        """Release table blocks beyond what ``n_tokens`` needs (chunked
        prefill pads the prompt to a chunk multiple; the pad tail's
        blocks come back here once the real length is known)."""
        keep = self.blocks_for(n_tokens)
        while len(table) > keep:
            self.release([table.pop()])

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per listed block. A block reaching
        refcount 0 returns to the free list — unless it is registered
        in the prefix index, in which case it parks in the cached-block
        LRU (reusable by future :meth:`match_prefix` hits, reclaimable
        by :meth:`allocate` under pressure). Releasing a block that is
        not held (already free or cached) raises — the double-free
        guard that keeps the free list corruption-proof."""
        for b in blocks:
            if not 1 <= b < self.num_blocks:
                raise ValueError(f"releasing block {b} outside the pool")
            if self._ref[b] == 0:
                raise ValueError(f"double free of block {b} (not held "
                                 "by any table)")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._used -= 1
                if b in self._block_key:
                    self._lru[b] = None     # newest at the end
                else:
                    self._free.append(b)
            else:
                self._extra_refs -= 1
                if self._ref[b] == 1:
                    self._shared_blocks -= 1

    #: legacy name — release() IS the free of the refcounted pool
    free = release

    # -- prefix cache --------------------------------------------------------

    def chain_keys(self, tokens):
        """Yield ``(chain_key, chunk_tokens)`` per FULL block-sized
        chunk of ``tokens`` (:func:`prefix_chain_keys` at this pool's
        ``block_size``) — lazy, and a pure function of the tokens, the
        property that makes index entries reusable even after their
        physical parent blocks were evicted and re-prefilled
        elsewhere."""
        return prefix_chain_keys(tokens, self.block_size)

    def peek_prefix(self, tokens, max_blocks: Optional[int] = None
                    ) -> tuple[list[int], int]:
        """Read-only longest-cached-prefix probe: ``(block_ids,
        n_revivals)`` where ``n_revivals`` counts matched blocks that
        are currently zero-ref (parked in the LRU — committing the
        match removes them from evictable capacity, so an admission
        capacity check must charge for them). Verifies each level's
        stored chunk AND parent key (collision => miss, never wrong
        KV). Mutates NOTHING: a failed admission probe re-run every
        engine iteration must not touch refcounts or perturb LRU
        order. ``max_blocks`` caps the walk — the engine passes
        ``(prompt_len - 1) // block_size`` so at least the final
        prompt token is always recomputed (its logits seed
        generation)."""
        out: list[int] = []
        revivals = 0
        parent = _CHAIN_ROOT
        for key, chunk in self.chain_keys(tokens):
            if max_blocks is not None and len(out) >= max_blocks:
                break
            entry = self._index.get(key)
            if entry is None or entry.chunk != chunk \
                    or entry.parent != parent:
                break
            out.append(entry.block)
            if self._ref[entry.block] == 0:
                revivals += 1
            parent = key
        return out, revivals

    def commit_match(self, blocks: Sequence[int]) -> None:
        """Take one reference on every peeked block (reviving zero-ref
        ones out of the LRU) — the write half of :meth:`peek_prefix`,
        called once admission capacity is assured."""
        for b in blocks:
            if self._ref[b] == 0:
                if b in self._hosted:
                    # a demoted block revived in place: its host copy
                    # stays resident (content-addressed — still valid)
                    del self._hosted[b]
                else:
                    del self._lru[b]
                self._used += 1
            else:
                self._extra_refs += 1
                if self._ref[b] == 1:
                    self._shared_blocks += 1
            self._ref[b] += 1
        if blocks:
            self.peak_used = max(self.peak_used, self._used)
            self.peak_shared_blocks = max(self.peak_shared_blocks,
                                          self._shared_blocks)
            self.peak_blocks_saved = max(self.peak_blocks_saved,
                                         self._extra_refs)

    def match_prefix(self, tokens, max_blocks: Optional[int] = None
                     ) -> list[int]:
        """Longest cached prefix of ``tokens`` in full blocks, with the
        references taken: peek + commit in one call. The caller owns
        the returned references (release them like any allocated
        block)."""
        out, _ = self.peek_prefix(tokens, max_blocks)
        self.commit_match(out)
        return out

    def register_prefix(self, tokens, table: Sequence[int]) -> int:
        """Publish the full-block prefix of ``tokens`` (whose KV lives
        in ``table``'s leading blocks) into the index; returns how many
        blocks were newly registered. Levels already present keep their
        existing entry — the first writer wins, later identical blocks
        stay private and flow back to the free list on release."""
        registered = 0
        parent = _CHAIN_ROOT
        for i, (key, chunk) in enumerate(self.chain_keys(tokens)):
            if i >= len(table):
                break
            if key not in self._index:
                b = int(table[i])
                if b not in self._block_key:
                    self._index[key] = CachedBlock(b, parent, chunk)
                    self._block_key[b] = key
                    registered += 1
            parent = key
        return registered

    # -- host-RAM spill tier --------------------------------------

    def set_spill(self, spill, host_budget: Optional[int] = None) -> None:
        """Install the spill hook (``block_id -> payload`` — the engine
        wires :func:`extract_blocks` over its live pools; payloads are
        opaque here beyond their ``nbytes``) and the host byte budget
        shared by demoted payloads and swap reservations (None =
        unbounded). With no hook installed every host-tier path is
        inert and the manager behaves exactly as before."""
        self._spill = spill
        self.host_budget = None if host_budget is None else int(host_budget)

    @property
    def host_tier_active(self) -> bool:
        """True once a spill hook is installed — the flag admission
        (``Scheduler._reserve``) keys its host-tier probe on."""
        return self._spill is not None

    def demote(self, max_blocks: int = 1) -> int:
        """Write back up to ``max_blocks`` of the COLDEST zero-ref
        cached blocks to the host tier: the device copy stays resident
        and matchable (a hit revives it in place, no transfer), but
        the id becomes reclaimable without data loss — under pressure
        :meth:`allocate` takes demoted blocks first and only the host
        copy survives. Returns how many blocks were demoted (0 when no
        spill hook is installed, the LRU is empty, or the budget is
        full)."""
        n = 0
        while n < max_blocks and self._lru and self._spill is not None:
            b = next(iter(self._lru))            # oldest
            key = self._block_key[b]
            if key in self._host_payloads:
                self._host_payloads.move_to_end(key)
            else:
                payload = self._spill(b)
                nbytes = int(getattr(payload, "nbytes", 0))
                if not self._host_admit(nbytes):
                    break                        # budget can't take it
                entry = self._index[key]
                self._host_payloads[key] = HostedBlock(
                    entry.parent, entry.chunk, payload, nbytes)
                self._host_bytes += nbytes
                self.prefix_demotions += 1
            del self._lru[b]
            self._hosted[b] = None
            n += 1
        return n

    def peek_hosted(self, tokens, start: int,
                    max_blocks: Optional[int] = None
                    ) -> tuple[list[int], bool]:
        """Read-only host-tier probe CONTINUING a device-level match:
        ``(chain_keys, missed)`` for the chunks from index ``start``
        (= the device-matched block count) whose payloads are resident
        host-side, chunk-and-parent verified like every lookup here;
        ``missed`` is True when the walk ended on a genuine miss
        rather than the ``max_blocks`` cap or the prompt running out —
        the hit-rate denominator's input. Mutates nothing (a failed
        admission probe re-runs every iteration)."""
        out: list[int] = []
        missed = False
        parent = _CHAIN_ROOT
        for i, (key, chunk) in enumerate(self.chain_keys(tokens)):
            if i < start:
                parent = key
                continue
            if max_blocks is not None and start + len(out) >= max_blocks:
                break
            entry = self._host_payloads.get(key)
            if entry is None or entry.chunk != chunk \
                    or entry.parent != parent:
                missed = True
                break
            out.append(key)
            parent = key
        return out, missed

    def note_host_probe(self, hits: int, missed: bool) -> None:
        """Account one COMMITTED admission's host-tier probe outcome
        (the write half of :meth:`peek_hosted` — counters move only
        when an admission actually lands, so failed-capacity re-probes
        do not inflate the hit rate)."""
        self.host_tier_lookups += int(hits) + (1 if missed else 0)

    def host_pin(self, keys: Sequence[int]) -> None:
        """Shield host-tier entries ``keys`` from budget eviction for
        the duration of one admission reservation: between the
        :meth:`peek_hosted` match and the :meth:`revive_hosted` commit
        the reservation's own ``allocate`` calls may evict cached
        blocks, and spilling THOSE on the way out must not push the
        matched (LRU-oldest — peek mutates nothing) payloads out of
        the budget window. While pinned entries block the budget,
        demotion simply drops instead of spilling — a demoted prefix
        is an opportunity, a matched one a commitment. Always paired
        with :meth:`host_unpin` (try/finally)."""
        self._host_pinned.update(keys)

    def host_unpin(self, keys: Sequence[int]) -> None:
        """Release a :meth:`host_pin` (the reservation committed via
        :meth:`revive_hosted` — which re-warms the entries — or rolled
        back)."""
        self._host_pinned.difference_update(keys)

    def revive_hosted(self, keys: Sequence[int], blocks: Sequence[int]
                      ) -> list[tuple[int, object]]:
        """Re-materialize host-tier entries ``keys`` into freshly
        ALLOCATED device blocks ``blocks`` (the caller owns them at ref
        1): each key is re-registered in the prefix index at its new
        block, and the returned ``(block, payload)`` pairs are the
        device-side scatters the CALLER must apply (every pool, target
        and draft alike) before any dispatch reads the blocks —
        exactly the :meth:`privatize` pending-copy contract. Payloads
        stay resident (content-addressed — a re-eviction re-demotes
        without a new copy)."""
        restores: list[tuple[int, object]] = []
        for key, b in zip(keys, blocks):
            entry = self._host_payloads[key]
            self._host_payloads.move_to_end(key)
            self._index[key] = CachedBlock(b, entry.parent, entry.chunk)
            self._block_key[b] = key
            self.host_tier_hits += 1
            restores.append((b, entry.payload))
        return restores

    def host_reserve(self, nbytes: int) -> bool:
        """Charge ``nbytes`` of swap-out payload against the host
        budget (evicting demoted payloads oldest-first to make room —
        a swapped request's restore is a promise, a demoted prefix
        only an opportunity). False = would not fit even empty, and
        the caller must fall back to recompute."""
        nbytes = int(nbytes)
        if self.host_budget is not None:
            while (self.hosted_bytes + nbytes > self.host_budget
                   and self._host_evict_one()):
                pass
            if self.hosted_bytes + nbytes > self.host_budget:
                return False
        self._swap_bytes_held += nbytes
        return True

    def host_release(self, nbytes: int) -> None:
        """Return a swap reservation (the request restored or died)."""
        self._swap_bytes_held -= int(nbytes)

    def _host_admit(self, nbytes: int) -> bool:
        """True when the budget can take one more demoted payload of
        ``nbytes`` after evicting older payloads as needed."""
        if self.host_budget is None:
            return True
        while (self.hosted_bytes + nbytes > self.host_budget
               and self._host_evict_one()):
            pass
        return self.hosted_bytes + nbytes <= self.host_budget

    def _host_evict_one(self) -> bool:
        """Drop the oldest demoted payload (True) or report the tier
        empty (False). A payload backing a currently-DEMOTED device
        block takes that block back to the plain cached LRU — its
        device copy is intact, it just lost the lossless-reclaim
        property — re-inserted at the COLD end (it was the tier's
        oldest)."""
        key = next((k for k in self._host_payloads
                    if k not in self._host_pinned), None)
        if key is None:                  # empty, or everything pinned
            return False
        entry = self._host_payloads.pop(key)
        self._host_bytes -= entry.nbytes
        self.host_evictions += 1
        ent = self._index.get(key)
        if ent is not None and ent.block in self._hosted:
            del self._hosted[ent.block]
            self._lru[ent.block] = None
            self._lru.move_to_end(ent.block, last=False)
        return True

    def privatize(self, table: list[int], lo: int, hi: int
                  ) -> list[tuple[int, int]]:
        """Copy-on-write for table blocks ``[lo, hi)`` that a request
        is about to scatter into: a block with refcount > 1 is swapped
        for a freshly-allocated private copy — the returned
        ``(src, dst)`` pairs are the device-side pool copies the CALLER
        must apply (to every pool addressed by this table, target and
        draft alike) before the write dispatch; a sole-owner block that
        is merely registered is unpublished and written in place (no
        copy — nobody else can be reading it). Raises
        :class:`PoolExhausted` if a copy target cannot be allocated."""
        copies: list[tuple[int, int]] = []
        for i in range(lo, min(hi, len(table))):
            b = table[i]
            if self._ref[b] > 1:
                [dst] = self.allocate(1)
                self._ref[b] -= 1
                self._extra_refs -= 1
                if self._ref[b] == 1:
                    self._shared_blocks -= 1
                table[i] = dst
                copies.append((b, dst))
                self.cow_copies += 1
            elif b in self._block_key:
                key = self._block_key.pop(b)
                del self._index[key]
        return copies

    def is_private(self, block: int) -> bool:
        """True when exactly one table holds ``block`` and it is not
        published in the prefix index — the only state a scatter may
        write without :meth:`privatize`."""
        return self._ref[block] == 1 and block not in self._block_key

    def ensure_private(self, table: Sequence[int], lo: int, hi: int) -> None:
        """Assert-style guard: every table block in ``[lo, hi)`` must be
        writable. Decode/verify write spans are private by construction
        (they sit past the cached prompt prefix); a shared block here
        means allocator-state corruption, so fail loudly instead of
        silently clobbering another request's KV."""
        for i in range(lo, min(hi, len(table))):
            if not self.is_private(table[i]):
                raise RuntimeError(
                    f"block {table[i]} (table index {i}) is shared or "
                    f"registered but sits in a write span — allocator "
                    f"state corrupted")

    def blocks_saved(self) -> int:
        """Block allocations the prefix cache is deduplicating RIGHT
        NOW: total extra references beyond each shared block's first
        (= blocks a cache-off run would additionally hold resident)."""
        return self._extra_refs

    def note_shared_reads(self, n_tokens: int) -> None:
        """Account decode/verify KV reads served out of shared
        (refcount >= 2) blocks — the read-side extension of the waste
        accounting: these tokens are resident ONCE but read by several
        requests' gathers."""
        self._shared_read_tokens += int(n_tokens)

    def shared_read_tokens(self, table: Sequence[int],
                           context_len: int) -> int:
        """How many of one slot's ``context_len`` resident tokens live
        in shared blocks (the per-step input to
        :meth:`note_shared_reads`)."""
        bs = self.block_size
        n = 0
        for i in range(self.blocks_for(context_len)):
            if i < len(table) and self._ref[table[i]] >= 2:
                n += min(bs, context_len - i * bs)
        return n

    def shared_read_frac(self) -> float:
        """Fraction of all useful gathered decode tokens that came out
        of shared blocks (0.0 before any decode)."""
        if self._gather_useful_tokens == 0:
            return 0.0
        return self._shared_read_tokens / self._gather_useful_tokens

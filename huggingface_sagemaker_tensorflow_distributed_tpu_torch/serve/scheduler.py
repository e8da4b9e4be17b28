"""Iteration-level (continuous) batching scheduler — Orca (Yu et al.,
OSDI 2022) semantics over a fixed set of decode slots.

Counterpart of the JAX package's ``serve/scheduler.py``. The engine calls
:meth:`Scheduler.admit` between decode steps; requests join and leave the
running batch at token granularity. States: WAITING -> PREFILL (chunked
prompt ingestion) -> DECODE (one token per step, or one verify window)
-> FINISHED.

- Admission order is the policy's (:mod:`.policy`): ``fifo`` walks the
  queue head, ``slo`` ranks the queue by the aging-bounded
  deadline/priority/cache-aware key. Either way a policy only reorders
  admission.
- With ``prefix_cache`` admission maps the longest cached full-block
  prefix of the prompt onto shared blocks
  (:meth:`~.paged_kv.BlockManager.peek_prefix`, then ``commit_match``
  once capacity is assured), charges the pool only for the private
  rest, and starts prefill at the chunk-grid point at or below the
  cached boundary; the overlap blocks the first chunk rewrites are
  privatized (copy-on-write) inside the same capacity check. Host-tier
  payloads past the device match are revived into fresh blocks.
- ``decode_lookahead`` is the span a decode dispatch may write past the
  resident context: 1, or ``speculate_k + 1`` for a speculative engine's
  verify window; every capacity decision reserves it.
- Preemption when the pool runs dry takes the youngest running request:
  vLLM recompute (release everything, fold the generated tokens into the
  prompt, rejoin the queue front) or, with the engine's swap hook, an
  extraction of its blocks to host that re-admits straight into DECODE.
  Preemption changes latency, never tokens.

Pure host-side Python over :class:`~.paged_kv.BlockManager`.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.paged_kv import (
    BlockManager,
    PoolExhausted,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.policy import (
    make_policy,
    parse_aging_s,
    parse_policy,
)

WAITING, PREFILL, DECODE, FINISHED = "waiting", "prefill", "decode", "finished"

_rid = itertools.count()


@dataclass
class Request:
    """One generation request. ``prompt`` is token ids [P]; the engine
    appends generated ids to ``output``. Timing fields are engine-side
    ``perf_counter`` stamps (None until reached).

    Sampling is per request: ``temperature == 0`` (the default) is
    greedy — the mode the engine's exactness gate vs ``generate_causal``
    pins; ``temperature > 0`` samples with optional top-k/top-p
    truncation, seeded by ``seed`` so the stream is reproducible
    (including across recompute preemption — the engine derives the
    n-th token's PRNG key from (seed, n) alone)."""

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
    # speculative-decode accounting (serve engine): draft tokens
    # proposed for / accepted by this request's verify windows — the
    # per-request acceptance rate the finish telemetry event carries
    spec_proposed: int = 0
    spec_accepted: int = 0
    # prefix-cache accounting: prompt tokens served out of shared KV
    # blocks vs prompt tokens admitted, summed across (re-)admissions —
    # the per-request cache_hit_rate the finish event carries
    prefix_cached_tokens: int = 0
    prefix_prompt_tokens: int = 0
    # lifecycle tracing: the engine stamps host-side phase
    # accounting here when its `timeline` knob is on — wall seconds per
    # phase (queue / prefill / decode / preempted; overhead is derived
    # at emission) and the compact coalesced segment list the
    # `request_timeline` telemetry event carries. `group` is an opaque
    # caller-supplied key (tenant, route, experiment arm) the SLO
    # attribution report aggregates by.
    group: str = ""
    phase_s: dict = field(default_factory=lambda: {
        "queue": 0.0, "prefill": 0.0, "decode": 0.0, "preempted": 0.0})
    segments: list = field(default_factory=list)
    preempt_t: Optional[float] = None
    # dispatch-ahead attribution cursor: where this
    # request's last attributed decode interval ended. Under overlap a
    # dispatch N is enqueued BEFORE iteration N−1's fetch lands, so
    # the per-request decode window [dispatch, fetch] of consecutive
    # iterations would overlap; clipping each window's start to this
    # cursor keeps the attributed intervals disjoint (the checkable-
    # decomposition invariant) while still counting the host work that
    # ran concurrently with the device as decode time, not overhead.
    decode_attr_end: Optional[float] = None
    blocked_iters: int = 0
    blocked_reason: Optional[str] = None
    cow_copies: int = 0
    # open-loop SLO contract: `arrival_s` is the request's
    # ARRIVAL stamp in the engine's perf_counter domain — distinct from
    # `submit_t`, so queue wait decomposes into pre-submit backlog
    # (submit_t − arrival_s: time the load generator held the request)
    # + in-engine queue (admit − submit_t). The slo_* targets are
    # deadline seconds (None = no target on that axis); the engine
    # writes the verdicts at finish — slack_s is the TIGHTEST remaining
    # margin across the set targets, negative on a miss.
    arrival_s: Optional[float] = None
    slo_ttft_s: Optional[float] = None
    slo_tpot_s: Optional[float] = None
    slo_met: Optional[bool] = None
    ttft_slo_met: Optional[bool] = None
    tpot_slo_met: Optional[bool] = None
    slack_s: Optional[float] = None
    # admission-policy contract: `deadline_s` is an
    # END-TO-END deadline in seconds measured from the request's
    # origin (arrival_s when the open-loop driver threaded one, else
    # submit_t); `priority` is the admission class, smaller = more
    # urgent, 0 default. Under policy=slo these order WHO admits WHEN
    # — never WHAT (outputs stay token-identical under every policy).
    # `aging_promoted` flips once the request waits past the
    # scheduler's aging bound (the starvation counter telemetry sums);
    # `deadline_miss` is the engine's finish verdict (None = no
    # deadline set).
    deadline_s: Optional[float] = None
    priority: int = 0
    aging_promoted: bool = False
    deadline_miss: Optional[bool] = None
    # swap-based preemption: the extracted host-side
    # BlockSet a swapped-out victim carries while WAITING, and the
    # context length it restores to. Unlike recompute, the generated
    # tokens stay in `output` (nothing folds into the prompt) — the
    # request resumes decoding from output[-1] the moment its blocks
    # scatter back, no re-prefill.
    swap_set: Optional[object] = None
    swap_context: int = 0
    # recompute preemption folds generated tokens back into the prompt;
    # this keeps the ORIGINAL prompt length so output accounting and
    # first-token semantics survive a preemption
    orig_prompt_len: int = field(default=-1)
    # fleet tracing: the Router mints `trace_id` at submit
    # and it rides the request across every engine it visits; `hop`
    # counts inter-engine moves (migrate_request, drain requeue) — 0
    # on the placement engine. `migrate_out_t` is the source-side
    # perf_counter stamp taken just before extraction and
    # `migrate_extract_s` the extraction seconds, both consumed by the
    # destination's restore apply to price the transport hop; empty
    # trace_id = tracing off (single-engine runs), which keeps every
    # telemetry event byte-identical to the pre-tracing stream.
    trace_id: str = ""
    hop: int = 0
    migrate_out_t: Optional[float] = None
    migrate_extract_s: float = 0.0

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
        if not isinstance(self.group, str):
            raise ValueError("group must be a string")
        for name in ("slo_ttft_s", "slo_tpot_s"):
            target = getattr(self, name)
            if target is not None and not target > 0:
                raise ValueError(f"{name} must be > 0 when set")
        if self.deadline_s is not None and not self.deadline_s > 0:
            raise ValueError("deadline_s must be > 0 when set")
        if isinstance(self.priority, bool) or not isinstance(
                self.priority, int):
            raise ValueError("priority must be an integer class "
                             "(smaller = more urgent)")

    @property
    def sampled(self) -> bool:
        return self.temperature > 0

    @property
    def has_slo(self) -> bool:
        return self.slo_ttft_s is not None or self.slo_tpot_s is not None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.submit_t is None or self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def cache_hit_rate(self) -> Optional[float]:
        """Fraction of admitted prompt tokens served from shared KV
        blocks (None before any admission)."""
        if self.prefix_prompt_tokens == 0:
            return None
        return self.prefix_cached_tokens / self.prefix_prompt_tokens


class Slot:
    """One decode slot's device-side bookkeeping: the physical block
    table, how much context is resident (``context_len``), and how far
    prefill has progressed (``prefill_pos``, over the CHUNK-PADDED
    prompt width)."""

    def __init__(self, index: int):
        self.index = index
        self.request: Optional[Request] = None
        self.table: list[int] = []
        self.context_len = 0
        self.prefill_pos = 0
        self.admit_seq = -1          # admission order, for victim choice
        # copy-on-write pool copies admission queued for this slot:
        # (src, dst) block pairs the ENGINE must apply to every pool
        # before the slot's first prefill dispatch
        self.pending_copies: list[tuple[int, int]] = []
        # host-RAM spill tier: (block, payload) revivals
        # admission queued — host-tier prefix payloads the ENGINE must
        # scatter into the listed fresh blocks before the slot's first
        # dispatch — and the swapped-out request's whole BlockSet,
        # restored into `table` at re-admission (same timing contract)
        self.pending_restores: list[tuple[int, object]] = []
        self.pending_swap_in: Optional[object] = None
        # dispatch-ahead pipeline: 1 while this slot rides
        # an in-flight decode dispatch whose token has not been
        # fetched yet — its newest token lives on the DEVICE, and its
        # host-visible generated count runs one behind by exactly this
        # amount (the engine's budget-finish prediction and sampled
        # fold indices add it back)
        self.inflight = 0

    @property
    def free(self) -> bool:
        return self.request is None

    def clear(self) -> None:
        self.request = None
        self.table = []
        self.context_len = 0
        self.prefill_pos = 0
        self.admit_seq = -1
        self.pending_copies = []
        self.pending_restores = []
        self.pending_swap_in = None
        self.inflight = 0


class Scheduler:
    """Admission into ``num_slots`` decode slots, chunked prefill,
    recompute preemption. The engine owns the clock and the device; this
    class owns WHO runs. Admission ORDER is pluggable:
    ``policy="fifo"`` (default) walks ``waiting[0]`` exactly as the
    serial scheduler always did — telemetry unchanged — while
    ``policy="slo"`` ranks the queue by the aging-bounded
    deadline/priority/cache-aware key of :mod:`~.serve.policy`. Either
    way a policy only reorders admission; preemption, capacity math
    and per-request outputs are untouched.

    Under the engine's dispatch-ahead loop every decision
    here consumes LAGGED observations: one decode dispatch may be in
    flight, so a slot freed by an un-fetched EOS is not yet free at
    admission time, and a riding slot's ``context_len`` was already
    advanced at dispatch (the write lands regardless of the token's
    value). That advance is what keeps the block math exact — the
    ``decode_lookahead`` reservation measured from the advanced
    context covers the in-flight step's write span by construction —
    and the engine drains the pipeline before any path that can
    preempt, so recompute always folds fully committed output."""

    def __init__(self, num_slots: int, blocks: BlockManager,
                 prefill_chunk: int, max_model_len: int,
                 decode_lookahead: int = 1, prefix_cache: bool = False,
                 policy=None, aging_s=None):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if decode_lookahead < 1:
            raise ValueError("decode_lookahead must be >= 1")
        if max_model_len % blocks.block_size:
            raise ValueError(
                f"max_model_len {max_model_len} must be a multiple of "
                f"block_size {blocks.block_size}")
        if max_model_len % prefill_chunk:
            # padded_prompt_len must never exceed max_model_len (the
            # engine's block tables are sized for it): with the chunk
            # dividing the width, ceil(p/C)*C <= max_model_len for
            # every admissible prompt
            raise ValueError(
                f"max_model_len {max_model_len} must be a multiple of "
                f"prefill_chunk {prefill_chunk}")
        self.slots = [Slot(i) for i in range(num_slots)]
        self.blocks = blocks
        self.prefill_chunk = int(prefill_chunk)
        self.max_model_len = int(max_model_len)
        # tokens a decode dispatch may WRITE past each slot's resident
        # context: 1 for plain decode, speculate_k + 1 for a
        # speculative engine's draft/verify window — every decode-side
        # capacity decision (submit-time worst case, per-iteration
        # block growth, gather-bucket need) reserves this span so a
        # verify dispatch can never address past its block table
        self.decode_lookahead = int(decode_lookahead)
        self.prefix_cache = bool(prefix_cache)
        self.waiting: list[Request] = []
        self._admit_seq = itertools.count()
        self._prefill_rr = 0
        self.n_preemptions = 0
        # admission policy: None for fifo — the original
        # admit path runs bit-for-bit. `policy_now` is the virtual
        # clock override the open-loop driver installs so aging and
        # deadline arithmetic replay deterministically; None = wall
        # (perf_counter, the engine's stamp domain).
        self.policy = parse_policy(policy)
        self.aging_s = parse_aging_s(aging_s)
        self._policy = make_policy(self.policy, self.aging_s)
        self.aging_promotions = 0
        self.policy_now: Optional[float] = None
        # swap-based preemption: the engine installs a
        # `hook(slot) -> bool` that may extract the victim's blocks to
        # host BEFORE release (True = swapped; the request's `swap_set`
        # is set and :meth:`preempt` skips the recompute prompt fold).
        # None = pure recompute.
        self.swap_hook = None

    # -- queue side ----------------------------------------------------------

    def submit(self, request: Request) -> None:
        total = len(request.prompt) + request.max_new_tokens
        if total + self.decode_lookahead - 1 > self.max_model_len:
            extra = ("" if self.decode_lookahead == 1 else
                     f" + verify-window lookahead "
                     f"{self.decode_lookahead - 1}")
            raise ValueError(
                f"request {request.rid}: prompt {len(request.prompt)} + "
                f"max_new_tokens {request.max_new_tokens}{extra} exceeds "
                f"max_model_len {self.max_model_len}")
        # worst-case lifetime block need: admission reserves the padded
        # prompt, decode grows to `total`, and a preemption at
        # max_new - 1 folds the generation back into a prompt padded up
        # to a chunk multiple again. A request whose worst case exceeds
        # the WHOLE pool can never run — admit() would park it at the
        # queue head forever (or a lone decode slot would preempt
        # itself in a loop), so reject at submit instead of livelocking.
        worst = max(self.padded_prompt_len(request),
                    total + self.decode_lookahead - 1,
                    -(-(total - 1) // self.prefill_chunk)
                    * self.prefill_chunk)
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

    def take_waiting(self) -> list[Request]:
        """Drain hook (multi-replica router): remove and
        return every WAITING (not-yet-admitted) request, preemption
        -requeued ones included — the router moves them onto sibling
        replicas (recompute semantics: a folded prompt rides along
        unchanged, exactly the state :meth:`preempt` builds). Resident
        requests are untouched."""
        moved, self.waiting = self.waiting, []
        return moved

    def adopt(self, request: Request) -> None:
        """Requeue hook: append an EXISTING request — a
        sibling replica's drain victim — to this queue WITHOUT the
        :meth:`submit` validation or a fresh submit stamp. The
        original submit already validated the worst-case block need
        (replicas are homogeneous, and the submit-time formula covers
        every preemption-folded state of the request), and re-running
        it on a folded prompt would double-count the generated tokens
        and spuriously reject requests near ``max_model_len`` — the
        same reason :meth:`preempt` re-inserts directly. Queue-wait
        accounting keeps running from the ORIGINAL submit stamp, so a
        drain shows up as queue time, never as a reset clock."""
        self.waiting.append(request)

    def adopt_resident(self, request: Request) -> None:
        """Migration hook: enqueue a sibling engine's LIVE
        resident at the queue FRONT. The request already held a slot —
        it carries its extracted block set (``swap_set``, restored
        through :meth:`_reserve_swapped` with zero re-prefill) or, for
        a mid-prefill cold move, just its unmodified prompt — and a
        migration must not demote it behind work that was never
        admitted. FIFO order among multiple migrants is the CALLER's
        job (insert in reverse admission order); validation is skipped
        for the same reason :meth:`adopt` skips it, except that a
        HETEROGENEOUS destination's geometry is no longer covered by
        the original submit — :func:`~.transport.can_accept` re-checks
        it before the transplant."""
        self.waiting.insert(0, request)

    # -- admission -----------------------------------------------------------

    def padded_prompt_len(self, request: Request) -> int:
        """Prompt width after right-padding to a prefill-chunk multiple
        (the engine's prefill dispatch is one static chunk shape)."""
        p = len(request.prompt)
        return p + (-p % self.prefill_chunk)

    def admit(self) -> list[Slot]:
        """Move waiting requests into free slots while block capacity
        holds. Admission reserves the FULL padded-prompt block span up
        front so prefill can never die mid-prompt; the pad tail's
        blocks are trimmed back at prefill completion. With
        ``prefix_cache`` the reservation is denominated in PRIVATE
        blocks: the longest cached full-block prefix is mapped onto
        shared blocks (charged to the pool once, whoever admitted them
        first), prefill starts at the chunk-grid point at/below the
        cached boundary, and the chunk-grid overlap — shared blocks
        the first prefill chunk rewrites — is privatized (COW) here,
        inside the same capacity check. Returns the slots admitted
        this call. Order is the policy's: fifo walks the queue head
        only; slo ranks the whole queue once per call and lets a
        smaller-demand candidate fill a slot the front-runner cannot
        — EXCEPT past an aging-promoted request, where admission
        stops entirely (the strict starvation bound: nothing younger
        queue-jumps a starving request, and liveness holds because
        :meth:`submit` already rejected can-never-fit requests)."""
        if self._policy is None:
            return self._admit_fifo()
        return self._admit_policy()

    def _admit_fifo(self) -> list[Slot]:
        admitted = []
        for slot in self.slots:
            if not self.waiting:
                break
            if not slot.free:
                continue
            if not self._try_reserve(self.waiting[0], slot):
                break                       # FIFO: no queue-jumping
            self.waiting.pop(0)
            admitted.append(slot)
        return admitted

    def _admit_policy(self) -> list[Slot]:
        now = self.policy_clock()
        for req in self.waiting:
            if not req.aging_promoted and self._policy.promoted(req, now):
                req.aging_promoted = True
                self.aging_promotions += 1
        ranked = self._policy.rank(self.waiting, now,
                                   self._demand_blocks)
        admitted = []
        for slot in self.slots:
            if not ranked:
                break
            if not slot.free:
                continue
            chosen = None
            for req in ranked:
                if self._try_reserve(req, slot):
                    chosen = req
                    break
                if req.aging_promoted:
                    # a promoted (starving) request that cannot fit
                    # blocks ALL younger admission — the aging bound
                    # is strict, not advisory
                    ranked = []
                    break
            if chosen is None:
                break
            # remove by identity: Request field equality can compare
            # array prompts elementwise
            ranked = [r for r in ranked if r is not chosen]
            for i, r in enumerate(self.waiting):
                if r is chosen:
                    del self.waiting[i]
                    break
            admitted.append(slot)
        return admitted

    def _try_reserve(self, req: Request, slot: Slot) -> bool:
        """Reserve ``slot`` for ``req`` (swapped or fresh) — True on
        success with the slot fully populated, False with every
        acquired reference rolled back. Shared by both admit orders so
        the reservation semantics cannot drift between policies."""
        if req.swap_set is not None:
            return self._reserve_swapped(req, slot)
        table, start0, copies, restores = self._reserve(req)
        if table is None:
            return False
        slot.request = req
        slot.table = table
        slot.context_len = 0
        slot.prefill_pos = start0
        slot.pending_copies = copies
        slot.pending_restores = restores
        slot.admit_seq = next(self._admit_seq)
        req.state = PREFILL
        return True

    def policy_clock(self) -> float:
        """The admission policy's clock: the driver-installed virtual
        stamp when set (deterministic open-loop replay), else wall
        ``perf_counter`` — the same domain as every request stamp."""
        return (time.perf_counter() if self.policy_now is None
                else self.policy_now)

    def blocked_head(self) -> Optional[Request]:
        """The request whose admission is blocked when slots/KV run
        out — ``waiting[0]`` under fifo, the policy's top-ranked
        candidate otherwise. The engine attributes blocked-iteration
        telemetry to it."""
        if not self.waiting:
            return None
        if self._policy is None:
            return self.waiting[0]
        return self._policy.rank(self.waiting, self.policy_clock(),
                                 self._demand_blocks)[0]

    def _demand_blocks(self, req: Request) -> int:
        """Predicted service demand in KV blocks for the policy key:
        the padded-prompt block need minus the ``peek_prefix`` cached
        span (a refcount-neutral, LRU-neutral probe), so under KV
        pressure the largest-cached-prefix request ranks first. A
        swapped-out victim's demand is exactly its extracted set."""
        if req.swap_set is not None:
            return int(req.swap_set.n_blocks)
        need = self.blocks.blocks_for(self.padded_prompt_len(req))
        if self.prefix_cache:
            bs = self.blocks.block_size
            shared, _ = self.blocks.peek_prefix(
                req.prompt, max_blocks=(len(req.prompt) - 1) // bs)
            need -= len(shared)
        return need

    def _reserve_swapped(self, req: Request, slot: Slot) -> bool:
        """Re-admit a SWAPPED-OUT request: allocate exactly
        the blocks its extracted :class:`~.paged_kv.BlockSet` fills,
        hand the set to the engine as the slot's pending swap-in (the
        scatter must land before any dispatch reads the table — the
        pending-copies timing contract), and resume in DECODE directly:
        the restored context IS the prefill, no prompt recompute. The
        generated tokens never left ``req.output``, so the decode feed
        (``output[-1]``) and the sampled fold indices are exactly the
        uninterrupted run's."""
        n = req.swap_set.n_blocks
        # charge the decode lookahead on top of the restored blocks so
        # the re-admitted request cannot bounce straight back out on
        # its first post-restore capacity check
        ahead = self.blocks.blocks_for(
            req.swap_context + self.decode_lookahead) - n
        if not self.blocks.can_allocate(n + max(0, ahead)):
            return False
        slot.request = req
        slot.table = self.blocks.allocate(n)
        slot.context_len = req.swap_context
        slot.prefill_pos = 0
        slot.pending_copies = []
        slot.pending_swap_in = req.swap_set
        slot.admit_seq = next(self._admit_seq)
        req.swap_set = None
        req.state = DECODE
        return True

    def _reserve(self, req: Request):
        """One request's admission reservation: ``(table, prefill_pos,
        cow_copies, host_restores)``, or ``(None, 0, [], [])`` when the
        pool cannot carry it yet (every acquired reference rolled
        back)."""
        bs = self.blocks.block_size
        C = self.prefill_chunk
        padded = self.padded_prompt_len(req)
        total_need = self.blocks.blocks_for(padded)
        if not self.prefix_cache:
            if not self.blocks.can_allocate(total_need):
                return None, 0, [], []
            return self.blocks.allocate(total_need), 0, [], []
        # the final prompt token is never served from cache — its
        # logits seed generation, so its block stays recomputed. Peek
        # first, commit only once capacity is assured: a failed probe
        # re-runs EVERY engine iteration while this request heads the
        # queue, and it must neither churn refcounts nor re-park LRU
        # entries as freshly used (which would bias eviction toward
        # everyone else's prefixes)
        max_cached = (len(req.prompt) - 1) // bs
        shared, revivals = self.blocks.peek_prefix(
            req.prompt, max_blocks=max_cached)
        # host-RAM spill tier: chunks past the device match
        # may still be resident host-side (demoted before eviction) —
        # each hit extends the cached prefix at the cost of one fresh
        # block plus the engine-applied scatter of its payload
        hosted_keys: list[int] = []
        host_missed = False
        if self.blocks.host_tier_active:
            hosted_keys, host_missed = self.blocks.peek_hosted(
                req.prompt, len(shared), max_blocks=max_cached)
        cached = (len(shared) + len(hosted_keys)) * bs
        # prefill resumes on the chunk grid; the overlap [start0,
        # cached) gets rewritten (with identical values) and must be
        # privately owned before the dispatch scatters into it
        start0 = (cached // C) * C
        overlap = cached // bs - start0 // bs
        private_need = total_need - len(shared) - len(hosted_keys)
        # committing the match pulls `revivals` blocks out of the
        # evictable LRU, so they are charged alongside the private
        # need; every host-tier revival additionally needs a fresh
        # device block to scatter its payload into
        if not self.blocks.can_allocate(
                private_need + overlap + revivals + len(hosted_keys)):
            return None, 0, [], []
        # pin the matched payloads across the commit: the allocations
        # below may evict cached blocks, and spilling those under a
        # tight host budget must not push the matched (still LRU-cold)
        # entries out before revive_hosted lands
        self.blocks.host_pin(hosted_keys)
        try:
            self.blocks.commit_match(shared)
            revive_blocks = self.blocks.allocate(len(hosted_keys))
            restores = self.blocks.revive_hosted(hosted_keys,
                                                 revive_blocks)
            if self.blocks.host_tier_active:
                self.blocks.note_host_probe(len(hosted_keys),
                                            host_missed)
            table = (shared + revive_blocks
                     + self.blocks.allocate(private_need))
            copies = self.blocks.privatize(table, start0 // bs,
                                           cached // bs)
        finally:
            self.blocks.host_unpin(hosted_keys)
        req.prefix_cached_tokens += start0
        req.prefix_prompt_tokens += len(req.prompt)
        return table, start0, copies, restores

    # -- prefill -------------------------------------------------------------

    def next_prefill_slots(self, max_n: int) -> list[Slot]:
        """Up to ``max_n`` DISTINCT prefill-state slots, round-robin
        from where the last call left off — the batch the engine packs
        into ONE prefill dispatch. Rotation is preserved across calls so
        no prefilling request starves when more exist than fit a
        dispatch."""
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
        """The iteration's prefill budget in TOKENS-PER-DISPATCH terms
        (Sarathi-flavored, redefined for batched prefill): with a full
        decode batch exactly one chunk's worth of tokens runs per
        iteration — bounding the decode stall a long prompt can inject
        to one chunk of compute — and every idle decode slot buys one
        more chunk of tokens, which the engine packs into as few
        batched dispatches as possible (refilling drained slots fast is
        worth more than the stall when the batch is running light)."""
        idle = max(1, len(self.slots) - n_active_decode)
        return self.prefill_chunk * idle

    def finish_prefill(self, slot: Slot) -> None:
        """Prefill consumed the whole padded prompt: context becomes the
        REAL prompt length, pad-tail blocks return to the pool, the
        prompt's full blocks are published into the prefix index (their
        KV is complete and final — registered blocks are read-only from
        here on), and the slot starts decoding."""
        req = slot.request
        slot.context_len = len(req.prompt)
        self.blocks.trim(slot.table, slot.context_len)
        if self.prefix_cache:
            # a speculative engine's preemption-resume path REWRITES
            # position p-1 (the folded prompt tail, re-fed through the
            # verify window) — so with a verify lookahead the block
            # containing it must never be published read-only
            tokens = (req.prompt if self.decode_lookahead == 1
                      else req.prompt[:len(req.prompt) - 1])
            self.blocks.register_prefix(tokens, slot.table)
        req.state = DECODE

    # -- decode-side capacity ------------------------------------------------

    def decode_slots(self) -> list[Slot]:
        return [s for s in self.slots
                if s.request is not None and s.request.state == DECODE]

    def max_decode_context(self) -> int:
        """The iteration's max decode context INCLUDING every position a
        dispatch may write this step (``context_len + decode_lookahead``:
        one slot for plain decode, the whole draft/verify window for a
        speculative engine) — the quantity the engine's gather-bucket
        choice covers. 0 with no decode work."""
        return max((s.context_len + self.decode_lookahead
                    for s in self.decode_slots()), default=0)

    def ensure_decode_capacity(self) -> list[Request]:
        """Guarantee every DECODE slot owns blocks for every position
        the next dispatch may write (``context_len + decode_lookahead``),
        preempting youngest-first when the pool runs dry. Returns the
        requests preempted this call. Termination: each preemption
        frees ≥ 1 block and empties a slot, and a lone decode slot can
        always be satisfied by the blocks everyone else released (its
        worst-case span was bounded at submit)."""
        preempted = []
        while True:
            ds = self.decode_slots()
            if not ds:
                return preempted
            short = [s for s in ds
                     if self.blocks.blocks_for(
                         s.context_len + self.decode_lookahead)
                     > len(s.table)]
            try:
                for slot in short:
                    self.blocks.grow(slot.table,
                                     slot.context_len + self.decode_lookahead)
                for slot in ds:
                    # the next dispatch writes [context, context +
                    # lookahead): that span is past the cached prompt
                    # prefix, hence private by construction — enforced
                    # here so a sharing bug fails loudly, not by
                    # clobbering another request's (or the cache's) KV
                    self.blocks.ensure_private(
                        slot.table, slot.context_len // self.blocks.block_size,
                        self.blocks.blocks_for(
                            slot.context_len + self.decode_lookahead))
                return preempted
            except PoolExhausted:
                victim = max(ds, key=lambda s: s.admit_seq)
                victim_req = victim.request
                self.preempt(victim)
                preempted.append(victim_req)

    def preempt(self, slot: Slot) -> None:
        """Preempt one slot, rejoining the queue FRONT (it keeps its
        place — preemption must not reorder FIFO service). Default is
        vLLM recompute: release everything and fold the generated
        tokens into the prompt. With a swap hook installed
        the hook may instead extract the victim's resident blocks to
        host BEFORE the release — the request then carries its
        ``swap_set`` while waiting and re-admits straight into DECODE,
        output unfolded, no re-prefill. Either way the blocks release
        here (swap extraction only COPIES), so the pool sees one
        preemption semantics."""
        req = slot.request
        swapped = bool(self.swap_hook is not None
                       and self.swap_hook(slot))
        if not swapped:
            req.prompt = np.concatenate(
                [req.prompt, np.asarray(req.output, np.int32)])
            req.output = []
        req.state = WAITING
        req.preemptions += 1
        self.n_preemptions += 1
        self.blocks.release(slot.table)
        slot.clear()
        self.waiting.insert(0, req)

    def finish(self, slot: Slot) -> Request:
        """Request complete: publish its GENERATED tail into the
        prefix index, then release the
        table. At finish every resident position's K/V is final —
        prompt AND generated — so the whole ``context_len`` span's
        full aligned blocks are registerable, which is what makes
        agentic multi-turn traffic (a client re-submitting its own
        completion as the next prompt) hit the cache instead of
        re-prefilling its own output. ``register_prefix`` only indexes
        FULL ``block_size`` chunks covered by the table, so the
        partially-filled last block (and, under the dispatch-ahead
        loop, any stale in-flight write past ``context_len``) is never
        published. Zero-ref registered blocks park in the LRU on
        release — reusable until pool pressure evicts them."""
        req = slot.request
        req.state = FINISHED
        if self.prefix_cache and slot.context_len > 0:
            full = np.concatenate(
                [req.prompt, np.asarray(req.output, np.int32)])
            self.blocks.register_prefix(full[:slot.context_len],
                                        slot.table)
        self.blocks.release(slot.table)
        slot.clear()
        return req

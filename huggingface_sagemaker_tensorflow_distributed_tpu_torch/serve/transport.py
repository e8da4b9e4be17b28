"""Cross-engine KV block-set transport (the JAX package's
``serve/transport.py``).

One primitive, :func:`migrate_request`, moves a live request between two
:class:`~.engine.ServeEngine` instances with zero re-prefill: the
request's block set leaves the source pools through
:func:`~.paged_kv.extract_blocks` (full logical blocks on the host: value
pools, int8 scale pools and draft pools together), the scheduler-side
:class:`~.scheduler.Request` moves with its generated tail, sampled seed,
SLO riders and timeline stamps, and the destination re-admits it through
the swapped-request path (:meth:`~.scheduler.Scheduler._reserve_swapped`):
it allocates exactly the set's blocks from its own pool, scatters them
before any dispatch reads the table and resumes in DECODE. A hot move
goes through the host even when both engines are on one card, as in the
JAX package: the payload is engine-geometry-free, and its bytes are what
the migration counters report.

Tokens stay exact by two invariants: the generated tokens never leave
``req.output`` (the decode feed is ``output[-1]`` on whichever engine runs
it), and a sampled request's n-th draw is a function of (its seed, n), so
a moved sampled stream is the unmoved one bit for bit.

Only the extraction waits on the card: the source's dispatch in flight is
landed first (the preemption rule: a migration acts on committed state),
then the block set is copied out.
"""

from __future__ import annotations

import time
from typing import Optional

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.paged_kv import (
    extract_blocks,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.scheduler import (
    DECODE,
    WAITING,
)

__all__ = ["TransportError", "migrate_request", "can_accept",
           "pool_signature", "land_pipeline"]


class TransportError(RuntimeError):
    """A request cannot move: not resident on the source, incompatible
    pool geometry, or a destination too small to ever hold it."""


def pool_signature(engine) -> tuple:
    """The engine's logical pool geometry: ``(block_size, per-pool
    (block shape, dtype), draft ditto)``. Shapes are whole: a
    tensor-parallel engine's pools report every rank's heads, as JAX's
    sharded pools report their global shape. Equal signatures mean a
    :class:`~.paged_kv.BlockSet` extracted from one engine scatters bit
    for bit into the other."""
    def sig(pools):
        return tuple(((int(p.shape[1]), int(p.shape[2]) * engine.tp, int(p.shape[3])),
                      str(p.dtype).replace("torch.", "")) for p in pools)
    draft = sig(engine._dkv.all()) if engine.speculative else None
    return (int(engine.blocks.block_size), sig(engine._kv.all()), draft)


def can_accept(dst, req, live: bool = False) -> bool:
    """True when ``dst`` could ever hold ``req``: the submit-time worst
    case (padded prompt, full generation plus the decode lookahead, the
    preemption-folded re-prefill) against the destination's own chunk
    grid, model length and whole pool. ``live=True`` also asks that the
    worst case fit the pool's headroom right now
    (:meth:`~.paged_kv.BlockManager.can_allocate`: free plus evictable
    cached blocks). A read only: no refcount, LRU or allocation moves."""
    s = dst.sched
    total = len(req.prompt) + req.max_new_tokens
    if total + s.decode_lookahead - 1 > s.max_model_len:
        return False
    worst = max(s.padded_prompt_len(req),
                total + s.decode_lookahead - 1,
                -(-(total - 1) // s.prefill_chunk) * s.prefill_chunk)
    need = s.blocks.blocks_for(worst)
    if need > s.blocks.num_blocks - 1:
        return False
    return s.blocks.can_allocate(need) if live else True


def land_pipeline(src) -> None:
    """Commit ``src``'s dispatch in flight (plain decode or speculative
    window), so that what follows acts on committed state. The commit
    may finish requests."""
    if src._pending is not None:
        src._flush("migrate")
    if src._pending_spec is not None:
        pending, src._pending_spec = src._pending_spec, None
        src._commit_spec(pending)


def migrate_request(src, dst, rid: int, prefetched=None,
                    extract_s: float = 0.0,
                    extract_t0: Optional[float] = None) -> Optional[dict]:
    """Move resident request ``rid`` from ``src`` to ``dst``.

    A DECODE resident moves hot: its context's block set is extracted to
    the host, the source's blocks are released, and the request enters
    the destination's queue at the front carrying the set as its
    ``swap_set``. A mid-prefill resident moves cold: no payload, the
    destination re-runs its prefill.

    The source's dispatch in flight is landed first; if that finishes the
    request, nothing moves and None is returned. Otherwise ``{"rid",
    "bytes", "context_len", "cold"}``. Raises :class:`TransportError`
    when the request is not resident on ``src``, the pool geometries
    differ, or ``dst`` could never hold it.

    ``prefetched`` is a :class:`~.paged_kv.BlockSet` the caller already
    extracted for this request in a batched cohort pull
    (:func:`~.paged_kv.extract_block_sets`, one wait for the cohort),
    with ``extract_s`` its share of the cohort's seconds and
    ``extract_t0`` the pull's start; it is used only while it still
    matches the slot's committed context, and then the request's
    migration hold opens at ``extract_t0``: the pull it rode lies inside
    the hold, as a sequential extraction does."""
    if src is dst:
        raise TransportError(
            f"request {rid}: source and destination are the same engine")
    if src.tp > 1 or dst.tp > 1:
        raise TransportError(
            f"request {rid}: a tensor-parallel engine (tp {max(src.tp, dst.tp)}) "
            "does not migrate requests yet: ROADMAP queue 1, item 11")
    if pool_signature(src) != pool_signature(dst):
        raise TransportError(
            f"request {rid}: engine pool geometries differ "
            f"({pool_signature(src)} vs {pool_signature(dst)})")
    if rid in src.finished:
        return None
    slot = next((s for s in src.sched.slots
                 if s.request is not None and s.request.rid == rid), None)
    if slot is None:
        raise TransportError(
            f"request {rid} is not resident on the source engine")
    req = slot.request
    if not can_accept(dst, req):
        raise TransportError(
            f"request {rid} can never fit the destination engine "
            f"(max_model_len {dst.sched.max_model_len}, pool "
            f"{dst.blocks.num_blocks - 1} blocks)")
    land_pipeline(src)
    if rid in src.finished:
        return None
    # the destination's re-admission closes this as the request's
    # migration hold (the timeline's "preempted" phase); the same stamp
    # opens the hop clock the destination's restore closes
    req.preempt_t = time.perf_counter()
    req.migrate_out_t = req.preempt_t
    cold = req.state != DECODE
    if cold:
        nbytes, ctx = 0, 0
        req.migrate_extract_s = 0.0
    else:
        n = src.blocks.blocks_for(slot.context_len)
        if prefetched is not None and prefetched.n_blocks == n:
            req.swap_set = prefetched
            req.migrate_extract_s = float(extract_s)
            if extract_t0 is not None:
                # the hold and the hop clock open where the cohort's pull
                # began (nothing ran for this request since: the pipeline
                # was landed before the pull)
                req.preempt_t = req.migrate_out_t = float(extract_t0)
        else:
            t0 = time.perf_counter()
            req.swap_set = extract_blocks(src._kv.all(), slot.table[:n],
                                          d_pools=src._draft_pools())
            req.migrate_extract_s = time.perf_counter() - t0
        req.swap_context = slot.context_len
        nbytes, ctx = req.swap_set.nbytes, slot.context_len
    src.blocks.release(slot.table)
    slot.clear()
    req.state = WAITING
    req.hop += 1
    src.migrations_out += 1
    dst.adopt_resident(req, from_replica=src.replica)
    if cold:
        # a cold move lands no restore on the destination, so its event
        # is emitted here; a hot move's comes from the destination's
        # restore, which knows restore_s
        kw = {}
        if src.replica is not None:
            kw["from_replica"] = src.replica
        if dst.replica is not None:
            kw["to_replica"] = dst.replica
        if req.trace_id:
            kw["trace_id"] = req.trace_id
            kw["hop"] = req.hop
        obs.serve("migrate", request=rid, migration_bytes=0,
                  restore_s=0.0, **kw)
    return {"rid": rid, "bytes": nbytes, "context_len": ctx,
            "cold": cold}

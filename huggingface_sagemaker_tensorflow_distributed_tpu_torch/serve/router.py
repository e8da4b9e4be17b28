"""Multi-replica serving (the JAX package's ``serve/router.py``): N
:class:`~.engine.ServeEngine` replicas, each with its own scheduler,
block manager, prefix cache and telemetry tags, behind one
``submit()``/``run()`` facade with a pluggable placement policy.

- ``round_robin``: cycle over the admitting replicas.
- ``least_loaded``: the argmin of ``waiting_depth + occupied_slots +
  kv_used_frac`` (each engine's :meth:`~.engine.ServeEngine.load_gauges`,
  host state only), ties to the lower index.
- ``affinity``: a router-level index of the prompts' chain keys
  (:func:`~.paged_kv.prefix_chain_keys`, the block-level prefix cache's
  own fingerprints) sends a request to the replica that holds its longest
  hashed prefix, LRU-aged to ``affinity_cap`` entries and bounded by
  ``affinity_max_skew``: past it, least-loaded wins (counted in
  ``affinity_fallbacks``).
- ``length_aware``: prompts at or above ``length_threshold`` go to the
  deepest capacity class (tensor-parallel degree, then pool blocks),
  shorter ones to the shallowest, skipping replicas whose pool cannot
  hold the request right now (``can_accept(live=True)``).

:meth:`Router.drain` stops admitting to a replica: its waiting requests
requeue onto siblings (recompute semantics), and its residents move
live through :func:`~.transport.migrate_request` with their block sets,
one cohort extraction for the whole drain. ``roles="prefill:N,decode:M"``
makes the first N replicas prefill-only; each finished prefill's block
set moves to the least-loaded decode replica between fleet iterations
(:meth:`Router._harvest`). Per-tenant token buckets (``rate_limit``)
reject a submit with a structured :class:`~.policy.RateLimited`.

Placement changes where a request runs, never what it emits. Every
replica launches on torch's current stream: a replica's decode
dispatched ahead stays in flight while the next replica runs its host
side, and the placement path reads host state only.

Telemetry: each replica's lifecycle events carry ``replica``; a traced
fleet (``trace``, default on) mints a ``trace_id`` per submit that every
event of the request carries, with its ``hop`` count (``obs/trace.py``
stitches them). ``run()`` ends with one report per replica and one
fleet report last. A one-replica router is a pass-through: it drives the
engine's own ``run()`` and tags nothing, so its events are the bare
engine's.
"""

from __future__ import annotations

import contextlib
import os
import time
import types
from collections import OrderedDict
from typing import Optional, Union

import numpy as np

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.report import (
    percentile,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import (
    ServeEngine,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.paged_kv import (
    extract_block_sets,
    prefix_chain_keys,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.policy import (
    RateLimited,
    TokenBucket,
    parse_aging_s,
    parse_policy,
    parse_rate_limit,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.scheduler import (
    DECODE,
    Request,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.transport import (
    TransportError,
    can_accept,
    land_pipeline,
    migrate_request,
)

ENV_REPLICAS = "HSTD_SERVE_REPLICAS"
ENV_PLACEMENT = "HSTD_SERVE_PLACEMENT"
ENV_ROLES = "HSTD_SERVE_ROLES"
ENV_TRACE = "HSTD_SERVE_TRACE"

PLACEMENTS = ("round_robin", "least_loaded", "affinity", "length_aware")


def parse_replicas(spec) -> int:
    """The replica-count knob: a positive int. None reads
    ``HSTD_SERVE_REPLICAS`` (default 1, the pass-through engine)."""
    if spec is None:
        spec = os.environ.get(ENV_REPLICAS, "1") or "1"
    try:
        n = int(str(spec).strip() or "1")
    except ValueError:
        raise ValueError(f"unparseable {ENV_REPLICAS} value {spec!r}: "
                         "expected a positive integer")
    if n < 1:
        raise ValueError(f"{ENV_REPLICAS} must be >= 1, got {n}")
    return n


def parse_roles(spec) -> Optional[dict]:
    """The disaggregation knob: ``prefill:N,decode:M`` (both >= 1) makes
    the first N replicas prefill-only and the next M decode-only; empty
    keeps every replica mixed. None reads ``HSTD_SERVE_ROLES``. A dict
    ``{"prefill": N, "decode": M}`` passes through."""
    if spec is None:
        spec = os.environ.get(ENV_ROLES, "")
    if isinstance(spec, dict):
        parts = {str(k).strip().lower(): v for k, v in spec.items()}
    else:
        s = str(spec).strip().lower()
        if not s:
            return None
        parts = {}
        for tok in s.split(","):
            role, sep, count = tok.partition(":")
            if not sep:
                raise ValueError(
                    f"unparseable {ENV_ROLES} value {spec!r}: expected "
                    "role:count pairs like 'prefill:1,decode:1'")
            parts[role.strip()] = count.strip()
    unknown = set(parts) - {"prefill", "decode"}
    if unknown:
        raise ValueError(
            f"unparseable {ENV_ROLES} value {spec!r}: unknown role(s) "
            f"{sorted(unknown)} (expected prefill / decode)")
    try:
        out = {"prefill": int(parts.get("prefill", 0)),
               "decode": int(parts.get("decode", 0))}
    except (TypeError, ValueError):
        raise ValueError(
            f"unparseable {ENV_ROLES} value {spec!r}: counts must be "
            "positive integers")
    if out["prefill"] < 1 or out["decode"] < 1:
        raise ValueError(
            f"{ENV_ROLES} needs at least one prefill and one decode "
            f"replica, got {out}")
    return out


def parse_placement(spec: Union[str, None]) -> str:
    """The placement knob: ``round_robin`` (default), ``least_loaded``,
    ``affinity`` or ``length_aware``. None reads
    ``HSTD_SERVE_PLACEMENT``."""
    if spec is None:
        spec = os.environ.get(ENV_PLACEMENT, "round_robin")
    s = str(spec).strip().lower() or "round_robin"
    if s not in PLACEMENTS:
        raise ValueError(f"unparseable {ENV_PLACEMENT} value {spec!r}: "
                         f"expected {' | '.join(PLACEMENTS)}")
    return s


def parse_trace(spec) -> bool:
    """The fleet-tracing knob: ``on`` (default) mints a ``trace_id`` and
    a hop counter per multi-replica submit; ``off`` mints nothing. None
    reads ``HSTD_SERVE_TRACE``. A one-replica router never mints."""
    if spec is None:
        spec = os.environ.get(ENV_TRACE, "on")
    s = str(spec).strip().lower() or "on"
    if s not in ("on", "off"):
        raise ValueError(f"unparseable {ENV_TRACE} value {spec!r}: "
                         "expected on | off")
    return s == "on"


class Router:
    """N :class:`~.engine.ServeEngine` replicas of one ``model`` behind one
    facade. ``replicas``/``placement``/``roles``/``trace`` read their
    ``HSTD_SERVE_*`` variables when None; every other keyword (``device``
    included) goes to each replica's engine, with ``replica_kwargs[i]``
    layered on top for replica i of a heterogeneous fleet. All replicas
    share the one model object, so the weights are held once.

    ``affinity_cap`` bounds the affinity index (oldest fingerprints leave
    first); ``affinity_max_skew`` (default: one engine's ``num_slots``)
    is the load difference past which an affinity hit yields to
    least-loaded placement."""

    def __init__(self, model, *, replicas=None, placement=None,
                 roles=None, replica_kwargs=None,
                 length_threshold: Optional[int] = None,
                 affinity_cap: int = 4096,
                 affinity_max_skew: Optional[int] = None,
                 trace=None, policy=None, aging_s=None,
                 rate_limit=None, **engine_kwargs):
        self.roles = parse_roles(roles)
        # parsed once and threaded into every replica, so one setting
        # configures the fleet alike
        self.policy = parse_policy(policy)
        self.aging_s = parse_aging_s(aging_s)
        if self.roles is not None:
            n_roles = self.roles["prefill"] + self.roles["decode"]
            if replicas is not None and parse_replicas(replicas) != n_roles:
                raise ValueError(
                    f"replicas={replicas} contradicts roles {self.roles} "
                    f"(= {n_roles} replicas): pass one or the other")
            self.n = n_roles
        else:
            self.n = parse_replicas(replicas)
        self.placement = parse_placement(placement)
        if replica_kwargs is not None and len(replica_kwargs) != self.n:
            raise ValueError(
                f"replica_kwargs has {len(replica_kwargs)} entries for "
                f"{self.n} replicas")
        self.engines = []
        for i in range(self.n):
            kw = dict(engine_kwargs, policy=self.policy, aging_s=self.aging_s)
            if replica_kwargs is not None:
                kw.update(replica_kwargs[i])
            self.engines.append(ServeEngine(model, **kw))
        if self.n > 1:
            for i, eng in enumerate(self.engines):
                eng.replica = i
        self.role_of: list[str] = (
            ["prefill"] * self.roles["prefill"]
            + ["decode"] * self.roles["decode"]
            if self.roles is not None else ["mixed"] * self.n)
        for i, eng in enumerate(self.engines):
            if self.role_of[i] == "prefill":
                eng.prefill_only = True
        self.block_size = self.engines[0].blocks.block_size
        self._rr = 0
        self._draining: set[int] = set()
        self._owner: dict[int, int] = {}        # rid -> replica index
        self.drains = 0
        self.requeues = 0
        self.migrations = 0
        # trace ids are a router-scoped sequence, so a replayed run
        # produces the same traces
        self.trace = parse_trace(trace) and self.n > 1
        self._trace_seq = 0
        if length_threshold is None:
            length_threshold = min(
                e.sched.max_model_len for e in self.engines) // 2
        self.length_threshold = int(length_threshold)
        self.affinity_cap = int(affinity_cap)
        if self.affinity_cap < 1:
            raise ValueError("affinity_cap must be >= 1")
        if affinity_max_skew is None:
            affinity_max_skew = self.engines[0].num_slots
        self.affinity_max_skew = float(affinity_max_skew)
        self.affinity_fallbacks = 0
        # chain key -> replica index, newest-used last
        self._affinity: "OrderedDict[int, int]" = OrderedDict()
        # per-tenant token buckets keyed on `group` ("*": the default)
        self._rate_spec = parse_rate_limit(rate_limit)
        self._buckets: dict[str, TokenBucket] = {}
        self.rate_limited = 0

    # -- placement -----------------------------------------------------------

    def _admitting(self) -> list[int]:
        return [i for i in range(self.n) if i not in self._draining]

    def _intake(self) -> list[int]:
        """Replicas new submissions may target: every admitting one,
        minus a disaggregated fleet's decode side."""
        cand = self._admitting()
        if self.roles is not None:
            cand = [i for i in cand if self.role_of[i] == "prefill"]
        return cand

    def _load(self, i: int) -> float:
        """One replica's placement score from its live gauges: queued and
        resident requests plus the KV pool pressure fraction."""
        g = self.engines[i].load_gauges()
        return g["waiting_depth"] + g["running"] + g["kv_used_frac"]

    def _least_loaded(self, cand: list[int]) -> int:
        return min(cand, key=lambda i: (self._load(i), i))

    def _affine(self, prompt, cand: list[int]) -> int:
        """The replica covering the prompt's longest hashed prefix, unless
        it is draining or past the imbalance bound (then least-loaded,
        counted)."""
        hit: Optional[int] = None
        for key, _chunk in prefix_chain_keys(prompt, self.block_size):
            rep = self._affinity.get(key)
            if rep is None:
                break
            hit = rep                    # the deepest indexed level wins
        if hit is None:
            return self._least_loaded(cand)
        if hit not in cand or (self._load(hit)
                               - min(self._load(i) for i in cand)
                               > self.affinity_max_skew):
            self.affinity_fallbacks += 1
            return self._least_loaded(cand)
        return hit

    def _register_affinity(self, prompt, replica: int) -> None:
        """Point every full-chunk fingerprint of ``prompt`` at the replica
        that will prefill it; the last writer wins, LRU-aged at
        ``affinity_cap``."""
        for key, _chunk in prefix_chain_keys(prompt, self.block_size):
            if key in self._affinity:
                self._affinity.move_to_end(key)
            self._affinity[key] = replica
        while len(self._affinity) > self.affinity_cap:
            self._affinity.popitem(last=False)

    def _place(self, prompt, max_new_tokens: int = 1) -> int:
        """The policy's choice only; :meth:`_commit_place` lands its state
        once the engine accepted the request. Under ``policy='slo'`` the
        default rotation yields to least-loaded placement."""
        cand = self._intake()
        if len(cand) == 1:
            return cand[0]
        if self.placement == "round_robin":
            if self.policy != "fifo":
                return self._least_loaded(cand)
            return cand[self._rr % len(cand)]
        if self.placement == "least_loaded":
            return self._least_loaded(cand)
        if self.placement == "length_aware":
            return self._length_aware(prompt, cand, max_new_tokens)
        return self._affine(prompt, cand)

    def _capacity_class(self, i: int) -> tuple:
        eng = self.engines[i]
        return (eng.tp, eng.blocks.num_blocks)

    def _length_aware(self, prompt, cand: list[int],
                      max_new_tokens: int = 1) -> int:
        """Long prompts to the deepest capacity class, short ones to the
        shallowest, least-loaded inside the class; a replica whose pool
        cannot carry the request's worst case right now is skipped for a
        class peer with room, then for any candidate with room."""
        shim = types.SimpleNamespace(
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=int(max_new_tokens))
        classes = {self._capacity_class(i) for i in cand}
        want = max(classes) if len(prompt) >= self.length_threshold \
            else min(classes)
        pool = [i for i in cand if self._capacity_class(i) == want]
        roomy = [i for i in pool
                 if can_accept(self.engines[i], shim, live=True)]
        if not roomy:
            roomy = [i for i in cand
                     if can_accept(self.engines[i], shim, live=True)]
        return self._least_loaded(roomy or pool)

    def _commit_place(self, prompt, choice: int) -> None:
        """An accepted request's placement state: the round-robin cursor
        (when there was a choice) or the affinity entries."""
        if self.placement == "round_robin":
            if len(self._intake()) > 1:
                self._rr += 1
        elif self.placement == "affinity":
            self._register_affinity(prompt, choice)

    # -- public API ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, **kw):
        """Place one request and queue it on the chosen replica; the
        engine's :meth:`~.engine.ServeEngine.submit` signature, and its
        :class:`~.scheduler.Request` back. A submit past its tenant's
        token bucket returns a :class:`~.policy.RateLimited` instead (a
        ``rate_limited`` event, counted); the bucket's clock is
        ``arrival_s`` when given, else wall."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        limited = self._rate_check(str(kw.get("group", "")),
                                   kw.get("arrival_s"))
        if limited is not None:
            return limited
        if self.roles is not None:
            # some decode replica must be able to hold it, or the
            # post-prefill handoff would retry forever
            shim = types.SimpleNamespace(
                prompt=prompt, max_new_tokens=int(max_new_tokens))
            if not any(can_accept(self.engines[j], shim)
                       for j in range(self.n)
                       if self.role_of[j] == "decode"):
                raise ValueError(
                    f"request (prompt {len(prompt)} + max_new_tokens "
                    f"{max_new_tokens}) can never fit any decode "
                    "replica of the disaggregated fleet")
        i = self._place(prompt, int(max_new_tokens))
        if self.trace and "trace_id" not in kw:
            kw = dict(kw, trace_id=f"t{self._trace_seq:06d}")
            self._trace_seq += 1
        req = self.engines[i].submit(prompt, max_new_tokens, **kw)
        self._commit_place(prompt, i)
        self._owner[req.rid] = i
        return req

    def _rate_check(self, group: str,
                    arrival_s: Optional[float]) -> Optional[RateLimited]:
        """One token-bucket decision for ``group`` (its own entry, else
        ``*``, else unlimited); buckets are per tenant."""
        if not self._rate_spec:
            return None
        spec = self._rate_spec.get(group, self._rate_spec.get("*"))
        if spec is None:
            return None
        bucket = self._buckets.get(group)
        if bucket is None:
            bucket = self._buckets[group] = TokenBucket(*spec)
        now = (time.perf_counter() if arrival_s is None
               else float(arrival_s))
        ok, retry_after = bucket.try_take(now)
        if ok:
            return None
        self.rate_limited += 1
        limited = RateLimited(group=group,
                              retry_after_s=round(retry_after, 6),
                              rate=spec[0], burst=spec[1])
        obs.serve("rate_limited", group=group,
                  retry_after_s=limited.retry_after_s,
                  rate_limited=self.rate_limited)
        return limited

    def replica_of(self, req: Union[Request, int]) -> int:
        """The replica that owns a request now (after requeues and
        migrations)."""
        rid = req.rid if isinstance(req, Request) else int(req)
        return self._owner[rid]

    def output_ids(self, req: Request) -> np.ndarray:
        return self.engines[self._owner[req.rid]].output_ids(req)

    @property
    def finished(self) -> dict[int, Request]:
        """{rid: Request} over every replica (rids are process-wide)."""
        out: dict[int, Request] = {}
        for eng in self.engines:
            out.update(eng.finished)
        return out

    def has_work(self) -> bool:
        return any(eng.has_work() for eng in self.engines)

    def warmup(self, sampled: bool = False) -> None:
        for eng in self.engines:
            eng.warmup(sampled=sampled)

    def step(self) -> None:
        """One fleet iteration: each replica with work runs one engine
        iteration; with the dispatch-ahead loop on, replica A's decode
        stays in flight while the replicas after it run their host side.
        A disaggregated fleet then hands finished prefills over."""
        for eng in self.engines:
            if eng.has_work():
                eng.step()
        if self.roles is not None:
            self._harvest()

    def _harvest(self) -> None:
        """Every request that finished prefill on a prefill replica (parked
        in DECODE) moves to the least-loaded admitting decode replica that
        can hold it; with none, the handoff waits for the next
        iteration."""
        for i, eng in enumerate(self.engines):
            if self.role_of[i] != "prefill":
                continue
            ready = sorted(
                (s for s in eng.sched.slots
                 if s.request is not None and s.request.state == DECODE),
                key=lambda s: s.admit_seq, reverse=True)
            for slot in ready:
                req = slot.request
                cand = [j for j in self._admitting()
                        if self.role_of[j] == "decode"
                        and can_accept(self.engines[j], req)]
                if not cand:
                    return
                j = self._least_loaded(cand)
                info = migrate_request(eng, self.engines[j], req.rid)
                if info is None:
                    continue        # finished at the handoff's commit
                self._owner[req.rid] = j
                self.migrations += 1

    def drain(self, i: int) -> list[Request]:
        """Stop admitting to replica i: its waiting requests requeue onto
        siblings through the placement policy (recompute semantics, the
        queue clock kept), its residents move live to the least-loaded
        sibling that can hold them (their block sets extracted as one
        cohort), and until :meth:`restart` no placement chooses it. A
        resident no sibling can take finishes in place
        (``residents_in_place``). Returns the requeued requests. Refuses
        to drain the last admitting replica (of its role)."""
        if not 0 <= i < self.n:
            raise ValueError(f"replica {i} out of range [0, {self.n})")
        if i in self._draining:
            raise ValueError(f"replica {i} is already draining")
        peers_like_i = [j for j in self._admitting()
                        if j != i and self.role_of[j] == self.role_of[i]]
        if not peers_like_i:
            role = ("" if self.roles is None
                    else f" {self.role_of[i]}-role")
            raise ValueError(
                f"cannot drain the last admitting{role} replica: "
                "restart a sibling first (a fleet must always have "
                "somewhere to place work)")
        self._draining.add(i)
        self.drains += 1
        src = self.engines[i]
        migrants = set(src._migrated_in)
        moved = src.take_waiting()
        for req in moved:
            if req.swap_set is not None:
                # a swapped victim (or a hot migrant not yet restored)
                # changing engines: its restore lands as a migration on
                # the destination; a swap victim's host reservation here
                # is returned
                if req.rid not in migrants:
                    src.blocks.host_release(req.swap_set.nbytes)
                cand = [j for j in self._drain_peers(i, req)
                        if can_accept(self.engines[j], req)]
                if cand:
                    j = self._least_loaded(cand)
                    src.migrations_out += 1
                    self.engines[j]._migrated_in[req.rid] = i
                    self.engines[j].adopt(req)
                else:
                    # no compatible sibling for the payload: recompute
                    req.swap_set = None
                    req.swap_context = 0
                    j = self._place(req.prompt, req.max_new_tokens)
                    self.engines[j].adopt(req)
                    self._commit_place(req.prompt, j)
            else:
                j = self._place(req.prompt, req.max_new_tokens)
                self.engines[j].adopt(req)
                self._commit_place(req.prompt, j)
            self._owner[req.rid] = j
            self.requeues += 1
            trace_kw = {}
            if req.trace_id:
                # a requeue is an inter-engine move: it advances the hop
                # and its event is the stitcher's evidence for that hop
                req.hop += 1
                trace_kw = {"trace_id": req.trace_id, "hop": req.hop}
            obs.serve("requeue", request=req.rid, replica=i,
                      to_replica=j, **trace_kw)
        migrated = 0
        residents_in_place = 0
        # land the pipeline once for the cohort: the committed state
        # decides who is hot, and the payloads must match it
        land_pipeline(src)
        resident_rids = [
            s.request.rid for s in sorted(
                (s for s in src.sched.slots if s.request is not None),
                key=lambda s: s.admit_seq, reverse=True)]
        # one extraction for every hot victim with a compatible peer (one
        # wait on the card for the cohort); its seconds are shared evenly
        # so each request's extract_s keeps its per-hop meaning
        prefetched: dict[int, object] = {}
        share = 0.0
        hot = [s for s in src.sched.slots
               if s.request is not None
               and s.request.state == DECODE
               and any(can_accept(self.engines[j], s.request)
                       for j in self._drain_peers(i, s.request))]
        if hot:
            id_lists = [s.table[:src.blocks.blocks_for(s.context_len)]
                        for s in hot]
            t0 = time.perf_counter()
            sets = extract_block_sets(src._kv.all(), id_lists,
                                      d_pools=src._draft_pools())
            share = (time.perf_counter() - t0) / len(hot)
            prefetched = {s.request.rid: bs for s, bs in zip(hot, sets)}
        for rid in resident_rids:
            if rid in src.finished:
                continue
            slot = next((s for s in src.sched.slots
                         if s.request is not None
                         and s.request.rid == rid), None)
            if slot is None:
                continue
            req = slot.request
            cand = [j for j in self._drain_peers(i, req)
                    if can_accept(self.engines[j], req)]
            if not cand:
                residents_in_place += 1
                continue
            j = self._least_loaded(cand)
            try:
                info = migrate_request(src, self.engines[j], rid,
                                       prefetched=prefetched.get(rid),
                                       extract_s=share)
            except TransportError:
                residents_in_place += 1
                continue
            if info is None:
                continue            # finished at the pipeline's commit
            self._owner[rid] = j
            self.migrations += 1
            migrated += 1
        obs.serve("drain", replica=i, requeued=len(moved),
                  migrated=migrated,
                  residents_in_place=residents_in_place,
                  placement=self.placement)
        return moved

    def _drain_peers(self, i: int, req: Request) -> list[int]:
        """Where a draining replica's request may go: any admitting
        sibling on a mixed fleet; on a disaggregated one, a DECODE (or
        swapped) request to the decode side, a mid-prefill one to another
        prefill replica."""
        if self.roles is None:
            return [j for j in self._admitting() if j != i]
        want = ("decode"
                if req.state == DECODE or req.swap_set is not None
                else "prefill")
        return [j for j in self._admitting()
                if j != i and self.role_of[j] == want]

    def restart(self, i: int) -> None:
        """Re-admit to a drained replica (nothing was torn down)."""
        if i not in self._draining:
            raise ValueError(f"replica {i} is not draining")
        self._draining.discard(i)
        obs.serve("restart", replica=i)

    def run(self) -> dict[int, Request]:
        """Drive the fleet until every request finished; the merged
        {rid: Request}. One replica: the engine's own ``run()``. More:
        one report event per replica, then the fleet's report last."""
        if self.n == 1:
            return dict(self.engines[0].run())
        self.warmup()
        with obs.span("serve/router_run"):
            while self.has_work():
                self.step()
        for eng in self.engines:
            obs.scalar(
                "serve/kv_peak_utilization",
                eng.blocks.peak_used / max(eng.blocks.num_blocks - 1, 1))
            summary = eng.slo_summary()
            if summary:
                obs.serve("report", **summary)
        summary = self.slo_summary()
        if summary:
            obs.serve("report", **summary)
        return self.finished

    # -- aggregates ----------------------------------------------------------

    def replica_load_imbalance(self) -> Optional[float]:
        """max/mean requests finished per replica (1.0 is even); None
        before any finish."""
        served = [len(eng.finished) for eng in self.engines]
        mean = sum(served) / len(served)
        if mean == 0:
            return None
        return max(served) / mean

    def slo_summary(self) -> dict:
        """The fleet's summary ({} until a request finishes; a one-replica
        router passes the engine's through): TTFT and e2e percentiles
        over every replica's requests, the fleet counters, the load
        imbalance, decode tokens/s, the prefix-cache hit rate, the open
        loop's attainment and backlog, and ``per_replica`` (and
        ``per_role``) breakdowns."""
        if self.n == 1:
            out = self.engines[0].slo_summary()
            if self.rate_limited and out:
                out = dict(out, rate_limited=self.rate_limited)
            return out
        reqs = [r for eng in self.engines for r in eng.finished.values()]
        if not reqs:
            return {}
        out: dict = {
            "requests": len(reqs),
            "replicas": self.n,
            "placement": self.placement,
            "tokens": sum(e.tokens_generated for e in self.engines),
            "iterations": sum(e.iterations for e in self.engines),
            "preemptions": sum(e.sched.n_preemptions for e in self.engines),
            "peak_waiting_depth": max(e.peak_waiting for e in self.engines),
            "drains": self.drains,
            "requeues": self.requeues,
        }
        mig_out = sum(e.migrations_out for e in self.engines)
        if mig_out:
            out["migrations"] = mig_out
            out["migration_bytes"] = sum(
                e.migration_bytes for e in self.engines)
            out["migration_restore_s"] = round(
                sum(e.migration_restore_s for e in self.engines), 6)
            hops = sorted(h for e in self.engines for h in e.transport_hop_s)
            if hops:
                out["transport_hop_s_p99"] = round(percentile(hops, 0.99), 6)
        imb = self.replica_load_imbalance()
        if imb is not None:
            out["replica_load_imbalance"] = round(imb, 4)
        if any(e._has_slo for e in self.engines):
            met = sum(e._slo_met for e in self.engines)
            total = sum(e._slo_total for e in self.engines)
            if total:
                out["slo_attainment"] = round(met / total, 4)
                groups: dict = {}
                for eng in self.engines:
                    for g, (m, t) in eng._group_slo.items():
                        acc = groups.setdefault(g, [0, 0])
                        acc[0] += m
                        acc[1] += t
                out["group_slo_attainment"] = {
                    g: round(m / t, 4)
                    for g, (m, t) in sorted(groups.items()) if t}
        if any(e._has_arrivals for e in self.engines):
            # summed per-replica peaks: an upper bound on the fleet's
            out["arrival_backlog_peak"] = sum(
                e._arrival_backlog_peak for e in self.engines)
        if self.policy != "fifo":
            out["policy"] = self.policy
            out["aging_promotions"] = sum(
                e.sched.aging_promotions for e in self.engines)
        if self.rate_limited:
            out["rate_limited"] = self.rate_limited
        dl_total = sum(e._deadline_total for e in self.engines)
        if dl_total:
            out["deadline_miss_frac"] = round(
                sum(e._deadline_miss for e in self.engines) / dl_total, 4)
        if any(e._has_priorities for e in self.engines):
            prios: dict = {}
            for eng in self.engines:
                for p, (m, t) in eng._priority_slo.items():
                    acc = prios.setdefault(p, [0, 0])
                    acc[0] += m
                    acc[1] += t
            if prios:
                out["priority_slo_attainment"] = {
                    str(p): round(m / t, 4)
                    for p, (m, t) in sorted(prios.items()) if t}
        if self.placement == "affinity":
            out["affinity_fallbacks"] = self.affinity_fallbacks
        dtok = sum(e.decode_tokens for e in self.engines)
        dsec = sum(e.decode_time_s for e in self.engines)
        if dsec > 0:
            out["decode_tokens_per_sec"] = round(dtok / dsec, 1)
        if self.engines[0].prefix_cache:
            admitted = sum(r.prefix_prompt_tokens for r in reqs)
            cached = sum(r.prefix_cached_tokens for r in reqs)
            out["prefix_cache"] = True
            out["prefix_cached_tokens"] = cached
            out["cache_hit_rate"] = (round(cached / admitted, 4)
                                     if admitted else 0.0)
        per_replica = []
        for i, eng in enumerate(self.engines):
            row = {
                "replica": i,
                "requests": len(eng.finished),
                "peak_waiting_depth": eng.peak_waiting,
                "preemptions": eng.sched.n_preemptions,
                "kv_peak_utilization": round(
                    eng.blocks.peak_used / max(eng.blocks.num_blocks - 1, 1),
                    4),
            }
            if self.roles is not None:
                row["role"] = self.role_of[i]
            hit = eng._aggregate_hit_rate()
            if hit is not None:
                row["cache_hit_rate"] = round(hit, 4)
            per_replica.append(row)
        out["per_replica"] = per_replica
        if self.roles is not None:
            out["roles"] = (f"prefill:{self.roles['prefill']},"
                            f"decode:{self.roles['decode']}")
            if "slo_attainment" in out:
                out["disagg_slo_attainment"] = out["slo_attainment"]
            out["per_role"] = self._per_role(reqs)
        ttfts = sorted(r.ttft_s for r in reqs if r.ttft_s is not None)
        e2es = sorted(r.finish_t - r.submit_t for r in reqs
                      if r.finish_t is not None and r.submit_t is not None)
        for label, vals in (("ttft", ttfts), ("e2e", e2es)):
            if not vals:
                continue
            out[f"{label}_p50_s"] = round(percentile(vals, 0.50), 6)
            out[f"{label}_p95_s"] = round(percentile(vals, 0.95), 6)
            out[f"{label}_p99_s"] = round(percentile(vals, 0.99), 6)
        return out

    def _per_role(self, reqs) -> dict:
        """A disaggregated fleet's split by phase: the prefill row carries
        the TTFT percentiles (first tokens come from the final prefill
        chunk), the decode row the TPOT percentiles and decode
        tokens/s."""
        def pcts(row, label, vals):
            vals = sorted(vals)
            if vals:
                row[f"{label}_p50_s"] = round(percentile(vals, 0.50), 6)
                row[f"{label}_p95_s"] = round(percentile(vals, 0.95), 6)
                row[f"{label}_p99_s"] = round(percentile(vals, 0.99), 6)

        out = {}
        for role in ("prefill", "decode"):
            ids = [i for i in range(self.n) if self.role_of[i] == role]
            engs = [self.engines[i] for i in ids]
            row: dict = {
                "replicas": ids,
                "prefill_chunks": sum(e.prefill_chunks for e in engs),
                "prefill_dispatches": sum(e.prefill_dispatches for e in engs),
                "decode_steps": sum(e.decode_steps for e in engs),
                "migrations_out": sum(e.migrations_out for e in engs),
                "migrations_in": sum(e.migrations_in for e in engs),
            }
            if role == "prefill":
                pcts(row, "ttft",
                     (r.ttft_s for r in reqs if r.ttft_s is not None))
            else:
                pcts(row, "tpot",
                     ((r.finish_t - r.first_token_t)
                      / max((len(r.prompt) - r.orig_prompt_len)
                            + len(r.output) - 1, 1)
                      for r in reqs
                      if r.finish_t is not None
                      and r.first_token_t is not None))
                dtok = sum(e.decode_tokens for e in engs)
                dsec = sum(e.decode_time_s for e in engs)
                if dsec > 0:
                    row["decode_tokens_per_sec"] = round(dtok / dsec, 1)
            out[role] = row
        return out

    @contextlib.contextmanager
    def draining(self, i: int):
        """``with router.draining(i):``: drain on entry, restart on exit
        (a rolling restart)."""
        self.drain(i)
        try:
            yield self
        finally:
            self.restart(i)

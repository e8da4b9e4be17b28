"""Continuous-batching serving engine for GPT-2 and the dense Llama
family over paged KV pools — the single-device ``ServeEngine`` of the
JAX package's ``serve/engine.py``. MoE models are refused, as there
(expert capacity follows the call's sequence length, so a chunked
prefill could drop what a one-shot one keeps).

Each :meth:`ServeEngine.step` admits waiting requests (the scheduler's
policy), runs batched chunked prefill under the token budget, grows the
decode slots' block tables (preempting by recompute or swap when the
pool runs dry), then runs one decode step (or one speculative window)
over every slot. The layers, each a knob that reads the JAX package's
``HSTD_SERVE_*`` variable with its default:

- **paged KV**: one pool per layer, ``[num_blocks, block_size, heads,
  head_dim]`` (K/V heads: ``num_kv_heads`` under GQA) (int8 with fp32 scale pools under
  ``kv_cache_dtype='int8'``); block 0 is the null block inactive slots
  write to. ``kv_pool_bytes`` sizes the pool from a byte budget.
- **batched chunked prefill**: up to ``prefill_batch`` prefilling slots'
  chunks in one ``[G, C]`` forward against dense caches gathered from
  the pools; the chunk's K/V is scattered back.
- **decode routes** (``kernel``): ``pallas`` (the port's default, on every
  device) feeds every slot's last token through the model's paged branch,
  whose attention is the hand-written CUDA kernel K3 on the card
  (``ops/paged_attention.py``; the plain version on the CPU); ``xla``
  gathers a dense cache from the pools and attends with the plain
  attention (the JAX package's default route).
- **gather-width ladder** (``gather_buckets``, default a quarter of
  ``max_model_len`` and the full width): each iteration runs at the
  smallest width that covers the largest decode context plus the write
  span. Growth is immediate, shrinking waits ``SHRINK_PATIENCE``
  iterations; every switch is a ``bucket_switch`` event. On the K3 route
  the width bounds the kernel's table walk; on the gather route it is
  the gathered cache's width.
- **prefix cache** (``prefix_cache``, default on): full block-aligned
  prompt chunks shared across requests through refcounted blocks
  (``serve/paged_kv.py``); a cached span's prefill is skipped (its
  blocks are written into the table), and a write into a shared block
  is preceded by a copy of the block in every pool (copy-on-write).
- **speculative decoding** (``speculate_k``, ``draft``): the draft model
  (self-draft layers sharing the target's tensors, or a ``(model,
  weights)`` pair) has its own pools over the same block tables; per
  iteration it proposes ``k`` tokens, one width-``k+1`` target pass
  verifies them on the gather route (K3 is single-token), greedy rows
  accept through ``speculative_accept_greedy`` and sampled rows through
  ``_speculative_accept``, and rejected tokens roll back by not
  advancing ``context_len`` over them.
- **swap and the host tier** (``swap``, ``swap_bytes``): preemption
  victims' blocks go to pinned host tensors and come back at
  re-admission (``always``; ``auto`` weighs bytes moved against the
  weight traffic a recompute streams), and with the prefix cache on,
  evicted cached blocks are demoted to the host tier and revived on a
  later match.
- **dispatch-ahead overlap** (``overlap``, default on): iteration N is
  dispatched before N-1's tokens reach the host; N feeds N-1's tokens,
  still on the card, and the fetch of N-1 is a ``non_blocking`` copy
  into a pinned buffer whose ``torch.cuda.Event`` the host waits on one
  iteration later. Budget finishes are excluded from N by count; an EOS
  is found one step late and the token in flight is discarded (its K/V
  lies past the finished request's context). Preemption and KV pressure
  drain the pipeline first; a lone stream runs serially.
- **admission policies** (``policy``, ``aging_s``) and **telemetry**:
  ``serve`` lifecycle events, ``request_timeline`` (a queue / prefill /
  decode / preempted / overhead decomposition that sums to the request's
  end-to-end time) and ``iteration_ledger`` events (``timeline``,
  default on), SLO and deadline verdicts at finish, and
  :meth:`~ServeEngine.slo_summary`.
- **fleet hooks** (the multi-replica router's, ``serve/router.py``):
  ``replica`` tags every lifecycle event and the report of replica i;
  ``prefill_only`` (a disaggregated fleet's prefill side) runs no decode
  phase, so finished prefills park in DECODE until the router migrates
  them; :meth:`~ServeEngine.take_waiting`, :meth:`~ServeEngine.adopt`
  and :meth:`~ServeEngine.adopt_resident` move requests between
  engines; :meth:`~ServeEngine.load_gauges` is the placement input. A
  migrated block set restores through the swap path's scatter and is
  counted as migration traffic (a ``migrate`` event). A request carrying
  a router-minted ``trace_id`` stamps it and its ``hop`` on every event
  it leaves; untraced requests add nothing.

Greedy output equals ``generate_causal`` and the JAX engine token for
token in every configuration; a sampled request's n-th token is drawn
with noise that is a function of (its seed, n) (a speculative window's
draws of (its seed, the window's first index)), so a stream is the same
across preemption, swap and overlap. Tensor parallelism (``mesh``,
``HSTD_SERVE_TP``) is not ported and raises.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs, resolve_device
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.generate import (
    _slot_gumbel,
    _speculative_accept,
    model_device,
    sample_per_slot,
    self_draft,
    speculative_accept_greedy,
    warp_logits_per_slot,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.kv_cache import (
    DenseCache,
    PagedCache,
    kv_heads_and_dim,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.report import (
    percentile,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.attention import (
    gather_paged_kv,
    scatter_paged_kv,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.paged_attention import (
    load_kernel,
    paged_decode_attention,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.paged_kv import (
    BlockManager,
    extract_blocks,
    insert_blocks,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.scheduler import (
    DECODE,
    Request,
    Scheduler,
)

ENV_GATHER_BUCKETS = "HSTD_SERVE_GATHER_BUCKETS"
ENV_SPECULATE_K = "HSTD_SERVE_SPECULATE_K"
ENV_DRAFT_LAYERS = "HSTD_SERVE_DRAFT_LAYERS"
ENV_PREFIX_CACHE = "HSTD_SERVE_PREFIX_CACHE"
ENV_KERNEL = "HSTD_SERVE_KERNEL"
ENV_KV_DTYPE = "HSTD_SERVE_KV_DTYPE"
ENV_TIMELINE = "HSTD_SERVE_TIMELINE"
ENV_OVERLAP = "HSTD_SERVE_OVERLAP"
ENV_TP = "HSTD_SERVE_TP"
ENV_SWAP = "HSTD_SERVE_SWAP"
ENV_SWAP_BYTES = "HSTD_SERVE_SWAP_BYTES"

#: the port's decode route when neither the caller nor the environment
#: names one: K3 on every device (the JAX package's default is ``xla``)
DEFAULT_KERNEL = "pallas"


def parse_tp(spec) -> int:
    """The tensor-parallel degree knob: a positive int. None reads
    ``HSTD_SERVE_TP`` (default 1, the single-device engine)."""
    if spec is None:
        spec = os.environ.get(ENV_TP, "1") or "1"
    try:
        tp = int(str(spec).strip() or "1")
    except ValueError:
        raise ValueError(f"unparseable {ENV_TP} value {spec!r}: "
                         "expected a positive integer")
    if tp < 1:
        raise ValueError(f"{ENV_TP} must be >= 1, got {tp}")
    return tp


def parse_kernel(spec: Union[str, None]) -> str:
    """The decode-route knob, in the JAX package's spellings: ``xla``
    (gather + dense attention) or ``pallas`` (the paged decode kernel,
    K3 on the card). None reads ``HSTD_SERVE_KERNEL``, default
    :data:`DEFAULT_KERNEL`."""
    if spec is None:
        spec = os.environ.get(ENV_KERNEL, DEFAULT_KERNEL)
    s = str(spec).strip().lower() or DEFAULT_KERNEL
    if s not in ("xla", "pallas"):
        raise ValueError(f"unparseable {ENV_KERNEL} value {spec!r}: "
                         "expected xla | pallas")
    return s


def parse_kv_dtype(spec: Union[str, None], model_default: str) -> str:
    """The pool-storage knob: ``fp`` or ``int8`` (scales ride in fp32
    pools beside the int8 ones). None reads ``HSTD_SERVE_KV_DTYPE``,
    falling back to the model config's own ``kv_cache_dtype``."""
    if spec is None:
        spec = os.environ.get(ENV_KV_DTYPE) or None
    if spec is None:
        return model_default
    s = str(spec).strip().lower()
    if s not in ("fp", "int8"):
        raise ValueError(f"unparseable {ENV_KV_DTYPE} value {spec!r}: "
                         "expected fp | int8")
    return s


def _parse_on_off(spec: Union[str, bool, None], env_var: str,
                  default: str = "on") -> bool:
    """Shared on/off parser: None reads ``env_var`` (else ``default``);
    accepts a bool or on/off/1/0/true/false/yes/no."""
    if spec is None:
        spec = os.environ.get(env_var, default)
    if isinstance(spec, bool):
        return spec
    s = str(spec).strip().lower()
    if s in ("on", "1", "true", "yes", ""):
        return True
    if s in ("off", "0", "false", "no"):
        return False
    raise ValueError(f"unparseable {env_var} value {spec!r}: "
                     "expected on/off")


def parse_prefix_cache(spec: Union[str, bool, None]) -> bool:
    """``HSTD_SERVE_PREFIX_CACHE``, default on."""
    return _parse_on_off(spec, ENV_PREFIX_CACHE)


def parse_timeline(spec: Union[str, bool, None]) -> bool:
    """``HSTD_SERVE_TIMELINE``, default on; ``off`` emits no
    ``request_timeline`` or ``iteration_ledger`` event."""
    return _parse_on_off(spec, ENV_TIMELINE)


def parse_overlap(spec: Union[str, bool, None]) -> bool:
    """``HSTD_SERVE_OVERLAP``, default on; ``off`` is the serial
    schedule -> dispatch -> fetch -> commit loop."""
    return _parse_on_off(spec, ENV_OVERLAP)


def parse_swap(spec: Union[str, None]) -> str:
    """The host-tier knob: ``off`` (default, no host tier), ``never``
    (prefix demotion only; preemption recomputes), ``always`` (swap every
    victim the budget takes) or ``auto`` (swap or recompute per victim).
    None reads ``HSTD_SERVE_SWAP``."""
    if spec is None:
        spec = os.environ.get(ENV_SWAP, "off")
    s = str(spec).strip().lower() or "off"
    if s not in ("auto", "always", "never", "off"):
        raise ValueError(f"unparseable {ENV_SWAP} value {spec!r}: "
                         "expected auto | always | never | off")
    return s


def parse_swap_bytes(spec: Union[str, int, None]) -> Optional[int]:
    """The host tier's byte budget (demoted payloads and swap
    reservations together); None or 0 is unbounded. None reads
    ``HSTD_SERVE_SWAP_BYTES``."""
    if spec is None:
        spec = os.environ.get(ENV_SWAP_BYTES) or None
    if spec is None:
        return None
    try:
        n = int(str(spec).strip() or "0")
    except ValueError:
        raise ValueError(f"unparseable {ENV_SWAP_BYTES} value {spec!r}: "
                         "expected a byte count (0/empty = unbounded)")
    if n < 0:
        raise ValueError(f"{ENV_SWAP_BYTES} must be >= 0, got {n}")
    return n or None


def parse_gather_buckets(spec: Union[str, Sequence[int], None],
                         max_model_len: int, block_size: int) -> list[int]:
    """The decode width ladder: ``"512,2048"``, a sequence of ints, or
    None/``"auto"`` for a quarter of ``max_model_len`` plus the full
    width; ``"full"``/``"off"`` is the full width alone. Widths round up
    to a block multiple and clip to ``max_model_len``, which is always on
    the ladder. Returns it sorted."""
    if spec is None or (isinstance(spec, str)
                        and spec.strip().lower() in ("", "auto")):
        widths = [max_model_len // 4]
    elif isinstance(spec, str):
        s = spec.strip().lower()
        if s in ("full", "off", "0"):
            widths = []
        else:
            try:
                widths = [int(x) for x in spec.split(",") if x.strip()]
            except ValueError:
                raise ValueError(
                    f"unparseable {ENV_GATHER_BUCKETS} value {spec!r}: "
                    "expected comma-separated widths, 'auto', or 'full'")
    else:
        widths = [int(x) for x in spec]
    out = set()
    for w in widths:
        if w <= 0:
            continue
        out.add(min(max_model_len, -(-w // block_size) * block_size))
    out.add(max_model_len)
    return sorted(out)


_M32 = 0xFFFFFFFF


def _mix32(h: int) -> int:
    """MurmurHash3's 32-bit finalizer on a Python int."""
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def kv_token_bytes(cfg, int8: bool) -> int:
    """Bytes one resident token costs across every pool of a model: K and
    V per layer and K/V head (GQA: ``num_kv_heads``), plus an int8 pool's
    fp32 scale."""
    heads, head_dim = kv_heads_and_dim(cfg)
    elem = 1 if int8 else torch.tensor([], dtype=cfg.dtype).element_size()
    return 2 * cfg.num_layers * heads * (head_dim * elem + (4 if int8 else 0))


def window_seeds(seed: int, start: int) -> tuple[int, int]:
    """The (draft, acceptance) noise seeds of a speculative window that
    starts at the request's ``start``-th token: a pure function of the
    two, so a window replayed after a preemption draws the same noise."""
    w = _mix32(_mix32((seed & _M32) ^ 0x5BD1E995) ^ (start & _M32))
    return _mix32(w ^ 0x1B873593), _mix32(w ^ 0xCC9E2D51)


class EngineStats(NamedTuple):
    decode_steps: int
    prefill_chunks: int
    prefill_dispatches: int
    tokens_generated: int
    decode_tokens: int
    decode_time_s: float
    preemptions: int
    bucket_switches: int
    kv_peak_utilization: float
    kv_utilization: float
    gather_waste_peak: float
    gather_waste_mean: float
    draft_proposed: int = 0
    draft_accepted: int = 0
    acceptance_rate: Optional[float] = None
    spec_windows: int = 0
    verify_waste_peak: float = 0.0
    verify_waste_mean: float = 0.0
    prefix_cache: bool = False
    prefix_cached_tokens: int = 0
    cache_hit_rate: Optional[float] = None
    blocks_shared_peak: int = 0
    blocks_saved_peak: int = 0
    cow_copies: int = 0
    prefix_evictions: int = 0
    shared_read_frac: float = 0.0
    peak_resident_requests: int = 0
    kernel: str = DEFAULT_KERNEL
    kv_dtype: str = "fp"
    kv_bytes_read: int = 0
    kv_token_bytes: int = 0
    overlap: bool = False
    overlap_flushes: int = 0
    tp: int = 1
    kv_pool_bytes_per_device: int = 0
    swap_policy: str = "off"
    swap_outs: int = 0
    swap_ins: int = 0
    swap_bytes: int = 0
    restore_s: float = 0.0
    recompute_tokens_avoided: int = 0
    host_tier_hits: int = 0
    host_tier_hit_rate: Optional[float] = None
    migrations_in: int = 0
    migrations_out: int = 0
    migration_bytes: int = 0
    # the port's own: K3 launches made by this engine's decode steps
    paged_kernel_launches: int = 0


class KVPools:
    """One model's KV address space: per-layer K and V pools (and fp32
    scale pools under int8) over ``num_blocks`` blocks."""

    def __init__(self, cfg, num_blocks: int, block_size: int, device,
                 int8: bool):
        heads, head_dim = kv_heads_and_dim(cfg)

        def pools(dim, dtype):
            return [torch.zeros(num_blocks, block_size, heads, dim,
                                dtype=dtype, device=device)
                    for _ in range(cfg.num_layers)]

        store = torch.int8 if int8 else cfg.dtype
        self.k, self.v = pools(head_dim, store), pools(head_dim, store)
        self.k_scale = pools(1, torch.float32) if int8 else None
        self.v_scale = pools(1, torch.float32) if int8 else None

    def fields(self) -> list:
        """(dense cache field, pools) pairs: K and V, and the scales."""
        pairs = [("keys", self.k), ("values", self.v)]
        if self.k_scale is not None:
            pairs += [("key_scales", self.k_scale),
                      ("value_scales", self.v_scale)]
        return pairs

    def all(self) -> list:
        """Every pool, in one fixed order (the :class:`~.paged_kv.
        BlockSet` payload order)."""
        return [p for _, pools in self.fields() for p in pools]

    def paged(self, tables: torch.Tensor, ctx: torch.Tensor) -> PagedCache:
        return PagedCache(self.k, self.v, self.k_scale, self.v_scale,
                          tables, ctx)

    def dense(self, tables: torch.Tensor, width: Optional[int],
              index: torch.Tensor) -> DenseCache:
        """Each row's contiguous cache gathered from the pools, over the
        first ``width`` positions of its table (all of them: None)."""
        g = {field: [gather_paged_kv(p, tables, width=width) for p in pools]
             for field, pools in self.fields()}
        return DenseCache(keys=g["keys"], values=g["values"],
                          key_scales=g.get("key_scales"),
                          value_scales=g.get("value_scales"), index=index)

    def scatter_rows(self, cache: DenseCache, tables: torch.Tensor,
                     start: torch.Tensor, n: int) -> None:
        """Write positions ``start[g] .. start[g] + n - 1`` of each row's
        dense cache back into the pools through its table (rows of
        inactive slots carry the null block's table)."""
        G = tables.shape[0]
        dev = tables.device
        positions = start.long()[:, None] + torch.arange(n, device=dev)[None, :]
        rows = torch.arange(G, device=dev)
        flat = positions.reshape(-1)
        tables_tok = tables.repeat_interleave(n, dim=0)
        for field, pools in self.fields():
            for buf, pool in zip(getattr(cache, field), pools):
                written = buf[rows[:, None], :, positions]    # [G, n, H, D]
                scatter_paged_kv(pool, tables_tok, flat,
                                 written.reshape(G * n, *written.shape[2:]))

    def copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write: block ``src`` duplicated into ``dst`` in every
        pool."""
        for p in self.all():
            p[dst] = p[src]


class _PendingDecode(NamedTuple):
    """One in-flight plain decode dispatch: the next tokens on the card,
    their pinned host copy and the event that marks it landed, the
    ``(slot, request)`` riders captured at dispatch, the width, and the
    dispatch's enqueue cost and stamp."""

    nxt: torch.Tensor
    host: Optional[torch.Tensor]
    event: Optional[object]
    riders: tuple
    bucket: int
    dispatch_s: float
    t_dispatch: float


class _PendingSpec(NamedTuple):
    """One in-flight speculative window: drafts, accepted counts and
    bonus tokens on the card, their pinned host copies and event. Its
    commit lands before the next window dispatches (the next window's
    inputs depend on the acceptance), so it overlaps the next
    iteration's admission, prefill and telemetry."""

    dev: tuple
    host: tuple
    event: Optional[object]
    riders: tuple
    bucket: int
    dispatch_s: float
    t_dispatch: float


class ServeEngine:
    """Continuous-batching engine over a
    :class:`~..models.gpt2.Gpt2LMHeadModel` or a dense
    :class:`~..models.llama.LlamaForCausalLM` that lives on ``device``
    (CUDA unless the caller names another; raises without it).

    ``num_blocks`` includes the reserved null block: allocatable KV is
    ``(num_blocks - 1) * block_size`` tokens shared by every request;
    ``kv_pool_bytes`` instead sizes it from a byte budget (target pools;
    a draft's pools ride on top). ``prefill_batch`` caps how many
    prefilling slots one prefill dispatch packs. The other knobs (module
    docstring): ``gather_buckets``, ``speculate_k`` and ``draft``,
    ``prefix_cache``, ``kernel``, ``kv_cache_dtype``, ``timeline``,
    ``overlap``, ``swap`` and ``swap_bytes``, ``policy`` and ``aging_s``.
    A speculative request reserves the verify window: ``prompt +
    max_new_tokens + speculate_k`` must fit ``max_model_len``. ``mesh``
    (an int degree above 1, or a mesh) raises: tensor parallelism is not
    ported."""

    #: consecutive iterations a smaller width must suffice before the
    #: ladder shrinks to it
    SHRINK_PATIENCE = 4

    def __init__(self, model, *, num_slots: int = 8, block_size: int = 16,
                 num_blocks: int = 129, prefill_chunk: int = 16,
                 max_model_len: Optional[int] = None,
                 gather_buckets: Union[str, Sequence[int], None] = None,
                 prefill_batch: int = 4,
                 speculate_k: Optional[int] = None,
                 draft=None,
                 prefix_cache: Union[str, bool, None] = None,
                 kernel: Union[str, None] = None,
                 kv_cache_dtype: Optional[str] = None,
                 kv_pool_bytes: Optional[int] = None,
                 timeline: Union[str, bool, None] = None,
                 overlap: Union[str, bool, None] = None,
                 mesh=None,
                 swap: Union[str, None] = None,
                 swap_bytes: Union[str, int, None] = None,
                 policy: Union[str, None] = None,
                 aging_s: Union[str, float, None] = None,
                 device=None):
        cfg = model.config
        if getattr(cfg, "num_experts", 0):
            raise ValueError(
                "ServeEngine does not support MoE models: expert "
                "capacity depends on the apply's sequence length, so "
                "chunked prefill could drop token->expert assignments "
                "the one-shot path never drops")
        if mesh is not None and not isinstance(mesh, (int, str)):
            raise NotImplementedError(
                "a serving mesh (tensor-parallel ServeEngine) is not ported "
                "yet: ROADMAP queue 1, item 11")
        self.tp = parse_tp(mesh)
        if self.tp > 1:
            raise NotImplementedError(
                f"tensor-parallel serving (tp {self.tp}) is not ported yet: "
                "ROADMAP queue 1, item 11")
        self.device = resolve_device(device)
        if model_device(model).type != self.device.type:
            raise ValueError(f"model lives on {model_device(model)}"
                             f", engine asked for {self.device}")
        self.kernel = parse_kernel(kernel)
        self.kv_cache_dtype = parse_kv_dtype(kv_cache_dtype, cfg.kv_cache_dtype)
        int8 = self.kv_cache_dtype == "int8"
        self.model = model
        self.eos_token_id = int(cfg.eos_token_id)
        self.pad_token_id = min(int(cfg.pad_token_id), cfg.vocab_size - 1)
        if max_model_len is None:
            max_model_len = (cfg.max_position_embeddings
                             // block_size) * block_size
        self.max_model_len = int(max_model_len)
        if self.max_model_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_model_len {self.max_model_len} exceeds the model's "
                f"max_position_embeddings {cfg.max_position_embeddings}")
        self.num_slots = int(num_slots)
        if speculate_k is None:
            speculate_k = int(os.environ.get(ENV_SPECULATE_K, "0") or 0)
        self.speculate_k = int(speculate_k)
        if self.speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {self.speculate_k}")
        self.prefix_cache = parse_prefix_cache(prefix_cache)
        self.timeline = parse_timeline(timeline)
        self.overlap = parse_overlap(overlap)
        token_bytes = kv_token_bytes(cfg, int8)
        if kv_pool_bytes is not None:
            num_blocks = max(2, 1 + int(kv_pool_bytes) // (block_size * token_bytes))
        self.blocks = BlockManager(num_blocks, block_size, token_bytes=token_bytes)
        self.sched = Scheduler(self.num_slots, self.blocks, prefill_chunk,
                               self.max_model_len,
                               decode_lookahead=self.speculate_k + 1,
                               prefix_cache=self.prefix_cache,
                               policy=policy, aging_s=aging_s)
        self.policy = self.sched.policy
        self.max_blocks_per_seq = self.max_model_len // block_size
        if gather_buckets is None:
            gather_buckets = os.environ.get(ENV_GATHER_BUCKETS)
        self.gather_buckets = parse_gather_buckets(
            gather_buckets, self.max_model_len, block_size)
        if self.speculate_k:
            if self.speculate_k + 1 > self.max_model_len:
                raise ValueError(
                    f"speculate_k {self.speculate_k} verify window does "
                    f"not fit max_model_len {self.max_model_len}")
            # widths too narrow for an empty-context window are never chosen
            self.gather_buckets = [b for b in self.gather_buckets
                                   if b >= self.speculate_k + 1]
        self.prefill_batch = max(1, min(int(prefill_batch), self.num_slots))
        self._kv = KVPools(cfg, num_blocks, block_size, self.device, int8)
        self.draft_model = None
        self._dkv: Optional[KVPools] = None
        if self.speculate_k:
            self.draft_model = self._build_draft(model, draft)
            self._dkv = KVPools(self.draft_model.config, num_blocks,
                                block_size, self.device, int8)
        self.finished: dict[int, Request] = {}
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.prefill_dispatches = 0
        self.tokens_generated = 0
        self.decode_tokens = 0
        self.decode_time_s = 0.0
        self.iterations = 0
        self.peak_waiting = 0
        self.peak_resident = 0
        self.bucket_switches = 0
        self.draft_proposed = 0
        self.draft_accepted = 0
        self.kv_bytes_read = 0
        self.spec_windows = 0
        self.paged_kernel_launches = 0
        # K3 launches by the width they walked
        self.paged_launches_by_width: dict[int, int] = {}
        # the host's blocked wait on decode results (the deferred event
        # under overlap; the fetch itself in the serial loop)
        self.fetch_wait_s = 0.0
        self.fetches = 0
        self._slo_total = 0
        self._slo_met = 0
        self._group_slo: dict[str, list] = {}
        self._arrival_backlog_peak = 0
        self._has_arrivals = False
        self._has_slo = False
        self._deadline_total = 0
        self._deadline_miss = 0
        self._priority_slo: dict[int, list] = {}
        self._has_priorities = False
        self._bucket = self.gather_buckets[0]
        self._shrink_streak = 0
        self._warmed = False
        self._pending: Optional[_PendingDecode] = None
        self._pending_spec: Optional[_PendingSpec] = None
        self.overlap_flushes = 0
        self._iter_prefill_s = 0.0
        self._iter_decode_s = 0.0
        self._iter_decode_slots = 0
        # fleet state: the router sets ``replica`` on an engine that is
        # one of N (None adds nothing to any event) and ``prefill_only``
        # on a disaggregated fleet's prefill side. ``_migrated_in`` maps
        # an adopted hot migrant's rid to its source replica until its
        # restore applies (migration accounting, not the swap tier's);
        # ``_migrate_hold`` marks traced rids whose next admission
        # closes a migration hold; ``transport_hop_s`` collects each
        # priced hop's seconds (source extraction stamp to scatter
        # complete).
        self.replica: Optional[int] = None
        self.prefill_only = False
        self.migrations_in = 0
        self.migrations_out = 0
        self.migration_bytes = 0
        self.migration_restore_s = 0.0
        self._migrated_in: dict[int, Optional[int]] = {}
        self._migrate_hold: set[int] = set()
        self.transport_hop_s: list[float] = []
        self.swap = parse_swap(swap)
        self.swap_bytes = parse_swap_bytes(swap_bytes)
        self.swap_ins = 0
        self.swap_outs = 0
        self.swap_bytes_moved = 0
        self.restore_s = 0.0
        self.recompute_tokens_avoided = 0
        if self.swap != "off":
            # host bytes one block costs across every pool, draft's
            # included; the recompute side of ``auto`` streams the
            # weights once per prefill dispatch
            self._host_block_bytes = block_size * (token_bytes + (
                kv_token_bytes(self.draft_model.config, int8) if self.speculate_k else 0))
            self._param_bytes = sum(p.numel() * p.element_size()
                                    for p in model.parameters())
            self.sched.swap_hook = self._swap_out
            if self.prefix_cache:
                self.blocks.set_spill(self._spill_block,
                                      host_budget=self.swap_bytes)

    def _build_draft(self, model, draft):
        """The proposer: an ``int`` (or None: ``HSTD_SERVE_DRAFT_LAYERS``,
        else a quarter of the target's layers) is ``self_draft``'s first
        layers, sharing the target's tensors; a ``(model, weights)`` pair
        loads ``weights`` (a state dict, or None to keep the model's
        own) into the draft model."""
        if isinstance(draft, tuple):
            dmodel, weights = draft
            if weights is not None:
                dmodel.load_state_dict(weights)
        else:
            layers = draft
            if layers is None:
                layers = (int(os.environ.get(ENV_DRAFT_LAYERS, "0") or 0)
                          or max(1, model.config.num_layers // 4))
            dmodel = self_draft(model, int(layers))
        if dmodel.config.vocab_size != model.config.vocab_size:
            raise ValueError(
                "draft and target must share a vocabulary (got "
                f"{dmodel.config.vocab_size} vs {model.config.vocab_size})")
        if model_device(dmodel).type != self.device.type:
            raise ValueError(f"draft model lives on "
                             f"{model_device(dmodel)}, engine on "
                             f"{self.device}")
        return dmodel.eval()

    # -- pools ---------------------------------------------------------------

    @property
    def k_pools(self) -> list:
        return self._kv.k

    @property
    def v_pools(self) -> list:
        return self._kv.v

    @property
    def k_scale_pools(self) -> Optional[list]:
        return self._kv.k_scale

    @property
    def v_scale_pools(self) -> Optional[list]:
        return self._kv.v_scale

    @property
    def speculative(self) -> bool:
        return self.speculate_k > 0

    def _draft_pools(self) -> Optional[list]:
        return self._dkv.all() if self._dkv is not None else None

    # -- requests -------------------------------------------------------------

    def _replica_kw(self) -> dict:
        """``{"replica": i}`` on replica i of a router fleet, ``{}``
        otherwise: a router-less (or one-replica) engine's events stay
        as they were."""
        return {} if self.replica is None else {"replica": self.replica}

    @staticmethod
    def _trace_kw(req: Request) -> dict:
        """``{"trace_id": ..., "hop": ...}`` when the request carries a
        router-minted trace context, ``{}`` otherwise."""
        if not req.trace_id:
            return {}
        return {"trace_id": req.trace_id, "hop": req.hop}

    def take_waiting(self) -> list[Request]:
        """Drain hook: remove and return every WAITING request (the
        scheduler's :meth:`~.scheduler.Scheduler.take_waiting`), leaving
        no per-request state of theirs behind here. Residents stay."""
        moved = self.sched.take_waiting()
        for req in moved:
            self._migrated_in.pop(req.rid, None)
            self._migrate_hold.discard(req.rid)
        return moved

    def adopt(self, req: Request) -> None:
        """Requeue hook: enqueue an EXISTING request (a sibling's drain
        victim) with its identity, folded prompt and submit stamp. A
        sampled stream's noise is a function of (seed, token index), so
        nothing re-derives: placement never changes tokens."""
        self.sched.adopt(req)

    def adopt_resident(self, req: Request,
                       from_replica: Optional[int] = None) -> None:
        """Migration hook: enqueue a sibling's LIVE resident at the queue
        front (:meth:`~.scheduler.Scheduler.adopt_resident`). A hot
        migrant carries its block set as ``swap_set``; registering it
        here routes its restore through migration accounting; a cold
        (mid-prefill) migrant re-prefills."""
        self.sched.adopt_resident(req)
        if req.swap_set is not None:
            self._migrated_in[req.rid] = from_replica
        else:
            self.migrations_in += 1
        if req.trace_id:
            self._migrate_hold.add(req.rid)

    def load_gauges(self) -> dict:
        """The placement inputs, read off the host-side scheduler and
        block manager (nothing on the card): waiting depth, occupied
        slots and KV pool pressure."""
        return {
            "waiting_depth": len(self.sched.waiting),
            "running": sum(1 for s in self.sched.slots if not s.free),
            "kv_used_frac": self.blocks.utilization(),
        }

    def has_work(self) -> bool:
        """True while anything is queued, resident or in flight."""
        return (self.sched.has_work() or self._pending is not None
                or self._pending_spec is not None)

    def submit(self, prompt, max_new_tokens: int, *, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 0.0, seed: int = 0,
               group: str = "", arrival_s: Optional[float] = None, slo=None,
               trace_id: str = "", deadline_s: Optional[float] = None,
               priority: int = 0) -> Request:
        """Queue one request: greedy at ``temperature=0``, else sampled
        (``top_k`` / ``top_p`` truncation, 0 disables each) from ``seed``.
        ``group`` tags it for SLO attribution; ``arrival_s`` is its arrival
        stamp (``perf_counter`` domain) when a load generator held it;
        ``slo`` any object with ``ttft_s`` / ``tpot_s`` targets
        (:class:`~.policy.SloSpec`); ``deadline_s`` an end-to-end
        deadline from its origin and ``priority`` its admission class
        (smaller is more urgent; both order admission under
        ``policy='slo'``). ``trace_id`` is a router-minted trace context
        (empty: none)."""
        req = Request(prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature), top_k=int(top_k),
                      top_p=float(top_p), seed=int(seed), group=str(group),
                      arrival_s=None if arrival_s is None else float(arrival_s),
                      slo_ttft_s=(None if slo is None or slo.ttft_s is None
                                  else float(slo.ttft_s)),
                      slo_tpot_s=(None if slo is None or slo.tpot_s is None
                                  else float(slo.tpot_s)),
                      trace_id=str(trace_id),
                      deadline_s=None if deadline_s is None else float(deadline_s),
                      priority=int(priority))
        req.submit_t = time.perf_counter()
        self.sched.submit(req)
        extra = {}
        if req.arrival_s is not None:
            self._has_arrivals = True
            extra["arrival_s"] = round(req.arrival_s, 6)
        if req.has_slo:
            self._has_slo = True
            if req.slo_ttft_s is not None:
                extra["slo_ttft_s"] = req.slo_ttft_s
            if req.slo_tpot_s is not None:
                extra["slo_tpot_s"] = req.slo_tpot_s
        if req.deadline_s is not None:
            extra["deadline_s"] = req.deadline_s
        if req.priority:
            self._has_priorities = True
            extra["priority"] = req.priority
        obs.serve("submit", request=req.rid, prompt_len=len(req.prompt),
                  max_new_tokens=req.max_new_tokens, sampled=req.sampled,
                  **self._replica_kw(), **self._trace_kw(req), **extra)
        return req

    def output_ids(self, req: Request) -> np.ndarray:
        """Generated ids (preemption-folded tokens included)."""
        folded = req.prompt[req.orig_prompt_len:]
        return np.concatenate(
            [folded, np.asarray(req.output, np.int32)]).astype(np.int32)

    def warmup(self, sampled: bool = False) -> None:
        """The warm pass before serving: on the card, build (at first use)
        and load K3's library so that no request pays for it; announce the
        starting width. Nothing compiles per shape, so ``sampled`` (the
        JAX engine's request for its sampled step variants) changes
        nothing."""
        if self._warmed:
            return
        if self.device.type == "cuda" and self.kernel == "pallas":
            load_kernel()
        obs.serve("bucket_switch", gather_bucket=self._bucket,
                  prev_bucket=None, max_context=0)
        self._warmed = True

    def run(self) -> dict[int, Request]:
        """Step until every submitted request finished; {rid: Request}.
        Ends with one ``serve`` *report* event carrying
        :meth:`slo_summary`."""
        self.warmup()
        with obs.span("serve/run"):
            while self.has_work():
                self.step()
        obs.scalar("serve/kv_peak_utilization",
                   self.blocks.peak_used / max(self.blocks.num_blocks - 1, 1))
        summary = self.slo_summary()
        if summary:
            obs.serve("report", **summary)
        return self.finished

    # -- reports --------------------------------------------------------------

    def slo_summary(self) -> dict:
        """TTFT / end-to-end latency percentiles and the scheduler, width,
        prefix-cache, speculation, host-tier and policy gauges over every
        finished request ({} until one finishes): the JAX engine's keys."""
        reqs = list(self.finished.values())
        if not reqs:
            return {}
        ttfts = [r.ttft_s for r in reqs if r.ttft_s is not None]
        e2es = [r.finish_t - r.submit_t for r in reqs
                if r.finish_t is not None and r.submit_t is not None]
        out = {
            "requests": len(reqs),
            "sampled_requests": sum(1 for r in reqs if r.sampled),
            "tokens": self.tokens_generated,
            "iterations": self.iterations,
            "preemptions": self.sched.n_preemptions,
            "peak_waiting_depth": self.peak_waiting,
            "bucket_switches": self.bucket_switches,
            "gather_bucket": self._bucket,
            "gather_read_waste_peak": round(self.blocks.peak_gather_waste, 4),
            "gather_read_waste_mean": round(self.blocks.gather_waste(), 4),
            "kv_peak_utilization": round(
                self.blocks.peak_used / max(self.blocks.num_blocks - 1, 1), 4),
        }
        if self.decode_time_s > 0:
            out["decode_tokens_per_sec"] = round(
                self.decode_tokens / self.decode_time_s, 1)
        out["kernel"] = self.kernel
        out["kv_dtype"] = self.kv_cache_dtype
        out.update(self._replica_kw())
        out["tp"] = self.tp
        out["kv_pool_bytes_per_device"] = self.blocks.pool_bytes
        if self.overlap:
            out["overlap"] = True
            out["overlap_flushes"] = self.overlap_flushes
        if self.decode_steps:
            out["kv_bytes_read_per_step"] = round(
                self.kv_bytes_read / self.decode_steps, 1)
        if self.timeline:
            qs = sorted(r.phase_s["queue"] for r in reqs)
            out["queue_wait_p50_s"] = round(percentile(qs, 0.50), 6)
            out["queue_wait_p99_s"] = round(percentile(qs, 0.99), 6)
            tot = sum(e2es)
            if tot > 0:
                sums = {ph: sum(r.phase_s[ph] for r in reqs)
                        for ph in ("queue", "prefill", "decode", "preempted")}
                for ph, v in sums.items():
                    out[f"{ph}_time_frac"] = round(v / tot, 4)
                out["overhead_time_frac"] = round(
                    1.0 - sum(sums.values()) / tot, 4)
        if self.prefix_cache:
            cached = sum(r.prefix_cached_tokens for r in reqs)
            admitted = sum(r.prefix_prompt_tokens for r in reqs)
            out["prefix_cache"] = True
            out["prefix_cached_tokens"] = cached
            out["cache_hit_rate"] = (round(cached / admitted, 4)
                                     if admitted else 0.0)
            out["blocks_shared_peak"] = self.blocks.peak_shared_blocks
            out["blocks_saved_peak"] = self.blocks.peak_blocks_saved
            out["cow_copies"] = self.blocks.cow_copies
            out["prefix_evictions"] = self.blocks.prefix_evictions
            out["shared_read_frac"] = round(self.blocks.shared_read_frac(), 4)
        out["peak_resident_requests"] = self.peak_resident
        if self._has_slo and self._slo_total:
            out["slo_attainment"] = round(self._slo_met / self._slo_total, 4)
            out["group_slo_attainment"] = {
                g: round(m / t, 4)
                for g, (m, t) in sorted(self._group_slo.items()) if t}
        if self._has_arrivals:
            out["arrival_backlog_peak"] = self._arrival_backlog_peak
        if self.policy != "fifo":
            out["policy"] = self.policy
            out["aging_promotions"] = self.sched.aging_promotions
        if self._deadline_total:
            out["deadline_miss_frac"] = round(
                self._deadline_miss / self._deadline_total, 4)
        if self._has_priorities and self._slo_total:
            out["priority_slo_attainment"] = {
                str(p): round(m / t, 4)
                for p, (m, t) in sorted(self._priority_slo.items()) if t}
        if self.swap != "off":
            out["swap_policy"] = self.swap
            out["swap_outs"] = self.swap_outs
            out["swap_ins"] = self.swap_ins
            out["swap_bytes"] = self.swap_bytes_moved
            out["restore_s"] = round(self.restore_s, 6)
            out["recompute_tokens_avoided"] = self.recompute_tokens_avoided
            out["host_tier_hits"] = self.blocks.host_tier_hits
            out["host_tier_hit_rate"] = round(
                self.blocks.host_tier_hits
                / max(1, self.blocks.host_tier_lookups), 4)
        if self.migrations_in or self.migrations_out:
            out["migrations_in"] = self.migrations_in
            out["migrations_out"] = self.migrations_out
            out["migration_bytes"] = self.migration_bytes
            out["migration_restore_s"] = round(self.migration_restore_s, 6)
        if self.speculative:
            out["speculate_k"] = self.speculate_k
            out["draft_proposed"] = self.draft_proposed
            out["draft_accepted"] = self.draft_accepted
            if self.draft_proposed:
                out["acceptance_rate"] = round(
                    self.draft_accepted / self.draft_proposed, 4)
            rates = sorted(r.spec_accepted / r.spec_proposed
                           for r in reqs if r.spec_proposed)
            if rates:
                out["acceptance_rate_p50"] = round(percentile(rates, 0.50), 4)
                out["acceptance_rate_min"] = round(rates[0], 4)
            out["verify_read_waste_peak"] = round(self.blocks.peak_verify_waste, 4)
            out["verify_read_waste_mean"] = round(self.blocks.verify_waste(), 4)
        for label, vals in (("ttft", ttfts), ("e2e", e2es)):
            if not vals:
                continue
            s = sorted(vals)
            out[f"{label}_p50_s"] = round(percentile(s, 0.50), 6)
            out[f"{label}_p95_s"] = round(percentile(s, 0.95), 6)
            out[f"{label}_p99_s"] = round(percentile(s, 0.99), 6)
        return out

    def stats(self) -> EngineStats:
        return EngineStats(
            decode_steps=self.decode_steps,
            prefill_chunks=self.prefill_chunks,
            prefill_dispatches=self.prefill_dispatches,
            tokens_generated=self.tokens_generated,
            decode_tokens=self.decode_tokens,
            decode_time_s=self.decode_time_s,
            preemptions=self.sched.n_preemptions,
            bucket_switches=self.bucket_switches,
            kv_peak_utilization=self.blocks.peak_used
            / max(self.blocks.num_blocks - 1, 1),
            kv_utilization=self.blocks.utilization(),
            gather_waste_peak=self.blocks.peak_gather_waste,
            gather_waste_mean=self.blocks.gather_waste(),
            draft_proposed=self.draft_proposed,
            draft_accepted=self.draft_accepted,
            acceptance_rate=(self.draft_accepted / self.draft_proposed
                             if self.draft_proposed else None),
            spec_windows=self.spec_windows,
            verify_waste_peak=self.blocks.peak_verify_waste,
            verify_waste_mean=self.blocks.verify_waste(),
            prefix_cache=self.prefix_cache,
            prefix_cached_tokens=sum(
                r.prefix_cached_tokens for r in self.finished.values()),
            cache_hit_rate=self._aggregate_hit_rate(),
            blocks_shared_peak=self.blocks.peak_shared_blocks,
            blocks_saved_peak=self.blocks.peak_blocks_saved,
            cow_copies=self.blocks.cow_copies,
            prefix_evictions=self.blocks.prefix_evictions,
            shared_read_frac=self.blocks.shared_read_frac(),
            peak_resident_requests=self.peak_resident,
            kernel=self.kernel,
            kv_dtype=self.kv_cache_dtype,
            kv_bytes_read=self.kv_bytes_read,
            kv_token_bytes=self.blocks.token_bytes,
            overlap=self.overlap,
            overlap_flushes=self.overlap_flushes,
            tp=self.tp,
            kv_pool_bytes_per_device=self.blocks.pool_bytes,
            swap_policy=self.swap,
            swap_outs=self.swap_outs,
            swap_ins=self.swap_ins,
            swap_bytes=self.swap_bytes_moved,
            restore_s=self.restore_s,
            recompute_tokens_avoided=self.recompute_tokens_avoided,
            host_tier_hits=self.blocks.host_tier_hits,
            host_tier_hit_rate=(
                self.blocks.host_tier_hits / max(1, self.blocks.host_tier_lookups)
                if self.swap != "off" else None),
            migrations_in=self.migrations_in,
            migrations_out=self.migrations_out,
            migration_bytes=self.migration_bytes,
            paged_kernel_launches=self.paged_kernel_launches)

    def _aggregate_hit_rate(self) -> Optional[float]:
        if not self.prefix_cache:
            return None
        admitted = sum(r.prefix_prompt_tokens for r in self.finished.values())
        if not admitted:
            return None
        return (sum(r.prefix_cached_tokens for r in self.finished.values())
                / admitted)

    # -- one iteration --------------------------------------------------------

    @torch.inference_mode()
    def step(self) -> None:
        """Admit, batched prefill under the token budget, decode-side
        capacity (preempting if needed), one decode step or window —
        dispatch-ahead under ``overlap``."""
        t_iter0 = time.perf_counter()
        tokens0 = self.tokens_generated
        chunks0, disp0 = self.prefill_chunks, self.prefill_dispatches
        self._iter_prefill_s = 0.0
        self._iter_decode_s = 0.0
        self._iter_decode_slots = 0
        for slot in self.sched.admit():
            n_cow = len(slot.pending_copies)
            if self.timeline:
                # the queue/preempted interval ends at admission; the
                # copies below land in overhead
                self._stamp_admit(slot, n_cow)
            self._apply_restores(slot)
            self._apply_cow(slot)
            extra = {}
            if self.prefix_cache:
                extra["prefix_cached_tokens"] = slot.prefill_pos
            obs.serve("admit", request=slot.request.rid, slot=slot.index,
                      queue_depth=len(self.sched.waiting), **self._replica_kw(),
                      **self._trace_kw(slot.request), **extra)
        if self.timeline and self.sched.waiting:
            head = self.sched.blocked_head()
            head.blocked_iters += 1
            head.blocked_reason = ("no_free_slot"
                                   if all(not s.free for s in self.sched.slots)
                                   else "kv_capacity")
        self.peak_resident = max(self.peak_resident,
                                 sum(1 for s in self.sched.slots if not s.free))
        C = self.sched.prefill_chunk
        budget = self.sched.prefill_token_budget(len(self.sched.decode_slots()))
        while budget >= C:
            # charged at dispatch cost, pad rows included
            rows = self._prefill_batch(budget // C)
            if not rows:
                break
            budget -= rows * C
        if self.prefill_only:
            # a disaggregated fleet's prefill side: no decode phase and no
            # capacity math (parked DECODE slots never grow here; the
            # router migrates them between iterations)
            pass
        elif not self.overlap:
            self._capacity_phase()
            self._decode_all()
        elif self.speculative:
            self._commit_spec(self._pending_spec)
            self._pending_spec = None
            self._capacity_phase()
            self._pending_spec = self._dispatch_spec()
        else:
            if self._pending is not None and not self._capacity_covered():
                self._flush("kv_pressure")
            self._capacity_phase()
            if self._lone_stream():
                # nothing to overlap with: land the dispatch in flight and
                # run this iteration serially
                prev, self._pending = self._pending, None
                self._commit_decode(prev)
                self._decode_all()
            else:
                prev, self._pending = self._pending, self._dispatch_decode()
                self._commit_decode(prev)
        waiting = len(self.sched.waiting)
        self.peak_waiting = max(self.peak_waiting, waiting)
        arrival_kw = {}
        if self._has_arrivals:
            backlog = sum(1 for r in self.sched.waiting if r.arrival_s is not None)
            self._arrival_backlog_peak = max(self._arrival_backlog_peak, backlog)
            arrival_kw["arrival_backlog"] = backlog
        if obs.has_sink():
            obs.scalar("serve/waiting_depth", waiting, self.iterations)
            obs.scalar("serve/running_slots", len(self.sched.decode_slots()),
                       self.iterations)
            obs.scalar("serve/preemptions", self.sched.n_preemptions,
                       self.iterations)
            obs.scalar("serve/gather_bucket", self._bucket, self.iterations)
            if self.timeline:
                obs.serve(
                    "iteration_ledger", iteration=self.iterations,
                    dur_s=round(time.perf_counter() - t_iter0, 6),
                    prefill_s=round(self._iter_prefill_s, 6),
                    decode_s=round(self._iter_decode_s, 6),
                    gather_bucket=self._bucket,
                    prefill_chunks=self.prefill_chunks - chunks0,
                    prefill_dispatches=self.prefill_dispatches - disp0,
                    decode_slots=self._iter_decode_slots,
                    tokens=self.tokens_generated - tokens0,
                    waiting=waiting,
                    kv_used_frac=round(self.blocks.utilization(), 4),
                    **arrival_kw, **self._replica_kw())
        self.iterations += 1

    def _capacity_phase(self) -> None:
        """Decode-side block capacity for the next dispatch, preempting
        when the pool runs dry (on committed state: under overlap the
        caller drained the pipeline first when this could preempt)."""
        for req in self.sched.ensure_decode_capacity():
            obs.serve("preempt", request=req.rid, reason="kv_pool_exhausted",
                      **self._replica_kw(), **self._trace_kw(req))
            if self.timeline:
                req.preempt_t = time.perf_counter()
                self._emit_timeline(req, "preempt", req.preempt_t)

    def _lone_stream(self) -> bool:
        """One decoding request and an empty queue: no host work to hide."""
        busy = [s for s in self.sched.slots if not s.free]
        return (not self.sched.waiting and len(busy) == 1
                and busy[0].request is not None
                and busy[0].request.state == DECODE)

    def _capacity_covered(self) -> bool:
        """True when every decode slot's next write span fits without the
        preemption path (else the pipeline drains first)."""
        need = sum(max(0, self.blocks.blocks_for(
            s.context_len + self.sched.decode_lookahead) - len(s.table))
            for s in self.sched.decode_slots())
        return self.blocks.can_allocate(need)

    def _flush(self, reason: str) -> None:
        """Drain the dispatch-ahead pipeline: commit the dispatch in flight
        now, so the next decision acts on committed state."""
        if self._pending is None:
            return
        self.overlap_flushes += 1
        prev, self._pending = self._pending, None
        self._commit_decode(prev)

    def _select_bucket(self, need: int) -> int:
        """The smallest width covering ``need``: growth at once, shrinking
        after ``SHRINK_PATIENCE`` iterations where the smaller width would
        have done."""
        fit = next(b for b in self.gather_buckets if b >= need)
        if fit > self._bucket:
            self._switch_bucket(fit, need)
        elif fit < self._bucket:
            self._shrink_streak += 1
            if self._shrink_streak >= self.SHRINK_PATIENCE:
                self._switch_bucket(fit, need)
        else:
            self._shrink_streak = 0
        return self._bucket

    def _switch_bucket(self, new: int, need: int) -> None:
        prev, self._bucket = self._bucket, new
        self._shrink_streak = 0
        self.bucket_switches += 1
        obs.serve("bucket_switch", gather_bucket=new, prev_bucket=prev,
                  max_context=need)

    # -- host <-> device --------------------------------------------------------

    def _h2d(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device; on the card through a
        pinned buffer and a ``non_blocking`` copy, so the host never waits
        on the work already queued."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _d2h_async(self, tensors: tuple) -> tuple:
        """``(host tensors, event)``: each tensor's ``non_blocking`` copy
        into a pinned buffer and the event that marks them landed (on the
        CPU the tensors themselves and no event)."""
        if self.device.type != "cuda":
            return tuple(tensors), None
        hosts = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            hosts.append(h)
        event = torch.cuda.Event()
        event.record()
        return tuple(hosts), event

    def _wait(self, event) -> float:
        """Block on ``event`` (None: nothing to wait for); the seconds
        waited, counted in :attr:`fetch_wait_s`."""
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        dt = time.perf_counter() - t0
        self.fetch_wait_s += dt
        self.fetches += 1
        return dt

    def _sampling(self, rows: list, R: int):
        """``None`` when no row samples, else the ``[R]`` host arrays
        (temperature, top-k, top-p, seed, token index) of ``rows``'
        ``(row, request, index)`` triples."""
        if not any(req.sampled for _, req, _ in rows):
            return None
        temps = np.zeros(R, np.float32)
        top_ks = np.zeros(R, np.int64)
        top_ps = np.zeros(R, np.float32)
        seeds = np.zeros(R, np.int64)
        folds = np.zeros(R, np.int64)
        for i, req, fold in rows:
            if req.sampled:
                temps[i], top_ks[i], top_ps[i] = req.temperature, req.top_k, req.top_p
                seeds[i], folds[i] = req.seed, fold
        return temps, top_ks, top_ps, seeds, folds

    def _next(self, logits: torch.Tensor, samp) -> torch.Tensor:
        """Each row's next token on the device (int64): the argmax, or
        ``sample_per_slot`` when a row samples."""
        if samp is None:
            return logits.argmax(-1)
        return sample_per_slot(logits.float(), *(self._h2d(a) for a in samp)).long()

    # -- prefill ----------------------------------------------------------------

    def _prefill_forward(self, model, kv: KVPools, chunks, tables, start, rel):
        """One ``[G, C]`` chunk forward of ``model`` against the rows'
        dense caches gathered from ``kv``; the chunk's K/V is scattered
        back. Returns the logits at each row's ``rel`` [G, V]."""
        G, C = chunks.shape
        max_ctx = tables.shape[1] * self.blocks.block_size
        cache = kv.dense(tables, None, start)
        # the chunk's slots are valid; the model's step mask imposes
        # causality inside the chunk, and pad-tail keys sit after every
        # real query
        valid = (torch.arange(max_ctx, device=self.device)[None, :]
                 < start[:, None] + C).long()
        positions = start[:, None] + torch.arange(C, device=self.device)[None, :]
        logits = model(chunks, valid, positions, cache)
        kv.scatter_rows(cache, tables, start, C)
        rows = torch.arange(G, device=self.device)
        return logits[rows, rel.clamp(0, C - 1)]

    def _prefill_batch(self, max_rows: int) -> int:
        """One batched prefill dispatch over up to ``min(max_rows,
        prefill_batch)`` prefilling slots: a lone slot runs as ``[1, C]``,
        more as ``[prefill_batch, C]`` with pad rows on the null block.
        Returns the dispatched row count (0 = no prefill work)."""
        slots = self.sched.next_prefill_slots(min(max_rows, self.prefill_batch))
        if not slots:
            return 0
        G = 1 if len(slots) == 1 else self.prefill_batch
        C = self.sched.prefill_chunk
        chunks = np.full((G, C), self.pad_token_id, np.int64)
        tables = np.zeros((G, self.max_blocks_per_seq), np.int32)
        start = np.zeros((G,), np.int64)
        rel = np.full((G,), -1, np.int64)
        finals = []
        for i, slot in enumerate(slots):
            req = slot.request
            pos = slot.prefill_pos
            real = req.prompt[pos:pos + C]
            chunks[i, :len(real)] = real
            tables[i, :len(slot.table)] = slot.table
            start[i] = pos
            if pos + C >= self.sched.padded_prompt_len(req):
                rel[i] = (len(req.prompt) - 1) - pos
                finals.append((i, slot))
        t0 = time.perf_counter()
        chunks_t, tables_t = self._h2d(chunks), self._h2d(tables)
        start_t, rel_t = self._h2d(start), self._h2d(rel)
        with obs.span("serve/prefill_chunk",
                      {"chunks": len(slots)} if obs.has_sink() else None):
            last = self._prefill_forward(self.model, self._kv, chunks_t,
                                         tables_t, start_t, rel_t)
            if self.speculative:
                # the draft's pools hold the prompt's K/V too
                self._prefill_forward(self.draft_model, self._dkv, chunks_t,
                                      tables_t, start_t, rel_t)
        if self.timeline:
            dur = time.perf_counter() - t0
            self._iter_prefill_s += dur
            for slot in slots:
                self._accrue_prefill(slot, t0, dur)
        for slot in slots:
            slot.prefill_pos += C
        self.prefill_chunks += len(slots)
        self.prefill_dispatches += 1
        if finals:
            samp = self._sampling([(i, slot.request, self._generated(slot.request))
                                   for i, slot in finals], G)
            # the first-token fetch: the sync that makes TTFT a wall time
            tok_host = self._next(last, samp).cpu().numpy()
            for i, slot in finals:
                req = slot.request
                self.sched.finish_prefill(slot)
                if self.speculative and self._generated(req) > 0:
                    # a preemption-resumed speculative request: its next
                    # tokens come from verify windows (the draws of the
                    # uninterrupted run); the window re-feeds the folded
                    # prompt's last token, whose K/V it rewrites as is
                    slot.context_len -= 1
                else:
                    self._append(slot, int(tok_host[i]))
        return G

    # -- plain decode -----------------------------------------------------------

    def _decode_step(self, tokens: torch.Tensor, tables: np.ndarray,
                     ctx: np.ndarray, samp, bucket: int) -> torch.Tensor:
        """Enqueue one decode step over every slot at width ``bucket``;
        returns the next tokens on the device. Inactive slots carry the
        null block's table and context 0."""
        bs = self.blocks.block_size
        ctx_t = self._h2d(ctx)
        launches0 = paged_decode_attention.launches
        if self.kernel == "pallas":
            # the kernel walks the first bucket // block_size columns
            cache = self._kv.paged(self._h2d(tables[:, :bucket // bs]), ctx_t)
            logits = self.model(tokens[:, None], None, ctx_t.long()[:, None], cache)
        else:
            tables_t = self._h2d(tables)
            cache = self._kv.dense(tables_t, bucket, ctx_t.long())
            valid = (torch.arange(bucket, device=self.device)[None, :]
                     <= ctx_t[:, None]).long()
            logits = self.model(tokens[:, None], valid, ctx_t.long()[:, None], cache)
            self._kv.scatter_rows(cache, tables_t, ctx_t, 1)
        launched = paged_decode_attention.launches - launches0
        if launched:
            self.paged_kernel_launches += launched
            self.paged_launches_by_width[bucket] = (
                self.paged_launches_by_width.get(bucket, 0) + launched)
        return self._next(logits[:, -1], samp)

    def _stage_decode(self, ds: list, bucket: int, inflight: bool):
        """The host arrays of one decode dispatch over ``ds``: tables,
        contexts, sampling; accounts the width's read waste, the pool
        bytes read and the reads out of shared blocks."""
        S = self.num_slots
        tables = np.zeros((S, self.max_blocks_per_seq), np.int32)
        ctx = np.zeros((S,), np.int32)
        for slot in ds:
            tables[slot.index, :len(slot.table)] = slot.table
            ctx[slot.index] = slot.context_len
        # the in-flight token counts: token N's index is its position
        samp = self._sampling([(s.index, s.request, self._generated(s.request)
                                + (s.inflight if inflight else 0)) for s in ds], S)
        self.blocks.note_gather([s.context_len + 1 for s in ds], bucket)
        step_bytes = self.num_slots * bucket * self.blocks.token_bytes
        self.kv_bytes_read += step_bytes
        if obs.has_sink():
            obs.scalar("serve/kv_bytes_read", step_bytes, self.iterations)
        if self.prefix_cache and self.blocks.blocks_saved() > 0:
            self.blocks.note_shared_reads(sum(
                self.blocks.shared_read_tokens(s.table, s.context_len)
                for s in ds))
        return tables, ctx, samp

    def _decode_all(self) -> None:
        """One serial decode iteration: dispatch, fetch, commit."""
        if self.speculative:
            self._commit_spec(self._dispatch_spec())
            return
        ds = self.sched.decode_slots()
        if not ds:
            return
        bucket = self._select_bucket(self.sched.max_decode_context())
        tables, ctx, samp = self._stage_decode(ds, bucket, inflight=False)
        tokens = np.zeros((self.num_slots,), np.int64)
        for slot in ds:
            tokens[slot.index] = slot.request.output[-1]
        t0 = time.perf_counter()
        with obs.span("serve/decode_step", {"active": len(ds), "gather_bucket": bucket}
                      if obs.has_sink() else None):
            nxt = self._decode_step(self._h2d(tokens), tables, ctx, samp, bucket)
            (host,), event = self._d2h_async((nxt,))
            self._wait(event)
            nxt = host.numpy()
        dur = time.perf_counter() - t0
        self.decode_time_s += dur
        self.decode_steps += 1
        self.decode_tokens += len(ds)
        if self.timeline:
            self._iter_decode_s += dur
            self._iter_decode_slots = len(ds)
        for slot in ds:
            slot.context_len += 1        # the fed token's K/V landed
            if self.timeline:
                self._accrue_decode(slot.request, t0, dur, bucket, 1)
            self._append(slot, int(nxt[slot.index]))

    def _dispatch_decode(self) -> Optional[_PendingDecode]:
        """Dispatch-ahead decode: enqueue iteration N without waiting for
        N-1's tokens. A rider of the dispatch in flight feeds its token
        still on the card; slots whose newest token is on the host (fresh
        from prefill, first step after a flush) merge in through one
        ``torch.where``. Slots that finish by budget at the pending commit
        are left out (a count); an EOS is found one step late and the
        wasted row's token is discarded at commit. Context lengths advance
        at dispatch (the write lands whatever the token), which keeps the
        width choice and the block math exact. Mirrors
        :meth:`_decode_all` rather than sharing it, so that the serial
        loop stays an independent reference."""
        prev = self._pending
        ds = [s for s in self.sched.decode_slots()
              if self._generated(s.request) + s.inflight < s.request.max_new_tokens]
        if not ds:
            return None
        bucket = self._select_bucket(
            max(s.context_len + self.sched.decode_lookahead for s in ds))
        tables, ctx, samp = self._stage_decode(ds, bucket, inflight=True)
        S = self.num_slots
        vals = np.zeros((S,), np.int64)
        use_dev = np.zeros((S,), bool)
        for slot in ds:
            if slot.inflight:
                use_dev[slot.index] = True
            else:
                vals[slot.index] = slot.request.output[-1]
        t0 = time.perf_counter()
        if prev is None or not use_dev.any():
            tokens = self._h2d(vals)
        elif all(s.inflight for s in ds):
            tokens = prev.nxt
        else:
            tokens = torch.where(self._h2d(use_dev), prev.nxt, self._h2d(vals))
        with obs.span("serve/decode_step", {"active": len(ds), "gather_bucket": bucket}
                      if obs.has_sink() else None):
            nxt = self._decode_step(tokens, tables, ctx, samp, bucket)
            (host,), event = self._d2h_async((nxt,))
        dispatch_s = time.perf_counter() - t0
        if self.timeline:
            self._iter_decode_s += dispatch_s
        for slot in ds:
            slot.context_len += 1
            slot.inflight = 1
        return _PendingDecode(nxt, host, event, tuple((s, s.request) for s in ds),
                              bucket, dispatch_s, t0)

    def _commit_decode(self, prev: Optional[_PendingDecode]) -> None:
        """Land one in-flight decode iteration: wait on its event (by now
        the card computed through the host work since the dispatch), then
        append per rider. A rider whose request finished at the previous
        commit has its token discarded, as the serial loop would never
        have computed it."""
        if prev is None:
            return
        fetch_s = self._wait(prev.event)
        t_end = time.perf_counter()
        nxt = prev.host.numpy()
        self.decode_time_s += prev.dispatch_s + fetch_s
        self.decode_steps += 1
        # riders of the dispatch now in flight keep their mark
        live = {id(s) for s, _ in (self._pending.riders
                                   if self._pending is not None else ())}
        committed = 0
        for slot, req in prev.riders:
            if id(slot) not in live:
                slot.inflight = 0
            if req.rid in self.finished or slot.request is not req:
                continue         # the wasted row past an EOS
            committed += 1
            self.decode_tokens += 1
            if self.timeline:
                # the request's decode interval is dispatch -> fetch,
                # clipped to its last attributed end (disjoint intervals)
                start = prev.t_dispatch
                if req.decode_attr_end is not None:
                    start = max(start, req.decode_attr_end)
                self._accrue_decode(req, start, t_end - start, prev.bucket, 1)
                req.decode_attr_end = t_end
            self._append(slot, int(nxt[slot.index]))
        if self.timeline:
            self._iter_decode_s += fetch_s
            self._iter_decode_slots = committed

    # -- speculative decode -------------------------------------------------------

    def _spec_step(self, tokens: torch.Tensor, tables: np.ndarray,
                   ctx: np.ndarray, samp, bucket: int) -> tuple:
        """Enqueue one speculative window over every slot at width
        ``bucket``: the draft proposes ``k`` tokens a step at a time
        against its dense cache (a ``k+1``-th step writes the last draft's
        K/V), one ``k+1``-wide target pass scores the window, and both
        window spans are scattered into their pools. Returns ``(drafts
        [S, k], n_acc [S], bonus [S])`` on the device; the draft and the
        verify go the gather route (K3 is single-token)."""
        k = self.speculate_k
        dev = self.device
        tables_t, ctx_t = self._h2d(tables), self._h2d(ctx).long()
        grid = torch.arange(bucket, device=dev)[None, :]
        if samp is not None:
            temps, top_ks, top_ps, seeds, folds = samp
            dseed = np.zeros_like(seeds)
            aseed = np.zeros_like(seeds)
            for i in np.nonzero(temps > 0)[0]:
                dseed[i], aseed[i] = window_seeds(int(seeds[i]), int(folds[i]))
            temps_t, top_ks_t, top_ps_t = (self._h2d(a) for a in (temps, top_ks, top_ps))
            dseed_t, aseed_t = self._h2d(dseed), self._h2d(aseed)
        d_cache = self._dkv.dense(tables_t, bucket, ctx_t.clone())
        tok, drafts, qs = tokens, [], []
        for t in range(k + 1):
            valid = (grid <= (ctx_t + t)[:, None]).long()
            lg = self.draft_model(tok[:, None], valid, (ctx_t + t)[:, None],
                                  d_cache)[:, -1].float()
            if t == k:
                break            # the step only wrote d_{k-1}'s K/V
            if samp is None:
                tok = lg.argmax(-1)
            else:
                tok = sample_per_slot(lg, temps_t, top_ks_t, top_ps_t, dseed_t,
                                      torch.full_like(dseed_t, t)).long()
                qs.append(torch.softmax(
                    warp_logits_per_slot(lg, temps_t, top_ks_t, top_ps_t), -1))
            drafts.append(tok)
        drafts = torch.stack(drafts, 1)
        self._dkv.scatter_rows(d_cache, tables_t, ctx_t, k + 1)
        verify_in = torch.cat([tokens[:, None], drafts], dim=1)
        t_cache = self._kv.dense(tables_t, bucket, ctx_t.clone())
        valid = (grid <= (ctx_t + k)[:, None]).long()
        win_pos = ctx_t[:, None] + torch.arange(k + 1, device=dev)[None, :]
        lg = self.model(verify_in, valid, win_pos, t_cache).float()   # [S, k+1, V]
        n_acc, bonus = speculative_accept_greedy(lg.argmax(-1), drafts)
        if samp is not None:
            S, V = lg.shape[0], lg.shape[-1]
            rep = (lambda x: x.repeat_interleave(k + 1))
            p = torch.softmax(warp_logits_per_slot(
                lg.reshape(S * (k + 1), V), rep(temps_t), rep(top_ks_t),
                rep(top_ps_t)), -1).reshape(S, k + 1, V)
            zero = torch.zeros_like(aseed_t)
            u = torch.exp(-torch.exp(-_slot_gumbel(aseed_t, zero, k)))
            n_acc_s, nxt_s = _speculative_accept(
                p, torch.stack(qs, 1), drafts, u,
                _slot_gumbel(aseed_t, zero + 1, V), _slot_gumbel(aseed_t, zero + 2, V))
            on = temps_t > 0
            n_acc = torch.where(on, n_acc_s, n_acc)
            bonus = torch.where(on, nxt_s.long(), bonus)
        self._kv.scatter_rows(t_cache, tables_t, ctx_t, k + 1)
        return drafts, n_acc, bonus

    def _dispatch_spec(self) -> Optional[_PendingSpec]:
        """Enqueue one speculative window over every decode slot; the
        commit (:meth:`_commit_spec`) lands the accepted drafts and the
        bonus token per slot."""
        ds = self.sched.decode_slots()
        if not ds:
            return None
        k = self.speculate_k
        bucket = self._select_bucket(self.sched.max_decode_context())
        S = self.num_slots
        tokens = np.zeros((S,), np.int64)
        tables = np.zeros((S, self.max_blocks_per_seq), np.int32)
        ctx = np.zeros((S,), np.int32)
        for slot in ds:
            req = slot.request
            # the newest committed token: the last generated one, or the
            # prompt's last on a fresh resume after preemption
            tokens[slot.index] = req.output[-1] if req.output else req.prompt[-1]
            tables[slot.index, :len(slot.table)] = slot.table
            ctx[slot.index] = slot.context_len
        samp = self._sampling([(s.index, s.request, self._generated(s.request))
                               for s in ds], S)
        self.blocks.note_gather([s.context_len + k + 1 for s in ds], bucket)
        step_bytes = self.num_slots * bucket * self.blocks.token_bytes
        self.kv_bytes_read += step_bytes
        if obs.has_sink():
            obs.scalar("serve/kv_bytes_read", step_bytes, self.iterations)
        if self.prefix_cache and self.blocks.blocks_saved() > 0:
            self.blocks.note_shared_reads(sum(
                self.blocks.shared_read_tokens(s.table, s.context_len)
                for s in ds))
        t0 = time.perf_counter()
        with obs.span("serve/spec_decode_step",
                      {"active": len(ds), "gather_bucket": bucket, "speculate_k": k}
                      if obs.has_sink() else None):
            dev = self._spec_step(self._h2d(tokens), tables, ctx, samp, bucket)
            host, event = self._d2h_async(dev)
        dispatch_s = time.perf_counter() - t0
        if self.timeline:
            self._iter_decode_s += dispatch_s
        return _PendingSpec(dev, host, event, tuple((s, s.request) for s in ds),
                            bucket, dispatch_s, t0)

    def _commit_spec(self, pending: Optional[_PendingSpec]) -> None:
        """Land one speculative window: one wait for (drafts, n_acc,
        bonus), then per slot the accepted prefix and the bonus token,
        ``context_len`` advanced over exactly the committed tokens (the
        rewind: rejected K/V past it is stale and masked, overwritten by
        the next window) and the table's tail past it released."""
        if pending is None:
            return
        ds = [slot for slot, _ in pending.riders]
        k = self.speculate_k
        fetch_s = self._wait(pending.event)
        t_end = time.perf_counter()
        drafts, n_acc, bonus = (h.numpy() for h in pending.host)
        self.decode_time_s += pending.dispatch_s + fetch_s
        self.decode_steps += 1
        self.spec_windows += len(ds)
        if self.timeline:
            self._iter_decode_s += fetch_s
            self._iter_decode_slots = len(ds)
        committed = []
        for slot in ds:
            req = slot.request
            i = slot.index
            acc = int(n_acc[i])
            self.draft_proposed += k
            self.draft_accepted += acc
            req.spec_proposed += k
            req.spec_accepted += acc
            if self.timeline:
                start = pending.t_dispatch
                if req.decode_attr_end is not None:
                    start = max(start, req.decode_attr_end)
                self._accrue_decode(req, start, t_end - start, pending.bucket,
                                    0, k, acc)
                req.decode_attr_end = t_end
            window = [int(drafts[i, j]) for j in range(acc)] + [int(bonus[i])]
            j = 0
            for tok in window:
                j += 1
                slot.context_len += 1    # this token's K/V is resident
                self.decode_tokens += 1
                if self.timeline:
                    req.segments[-1]["tokens"] += 1
                self._append(slot, tok)
                if req.rid in self.finished:
                    break                # EOS / budget: drop the rest
            committed.append(j)
            if req.rid not in self.finished:
                self.blocks.trim(slot.table, slot.context_len)
        self.blocks.note_verify(committed, k + 1)

    # -- lifecycle tracing ----------------------------------------------------------
    #
    # Host-side perf_counter stamps: queue + prefill + decode + preempted +
    # overhead sums to each request's end-to-end time (overhead is the
    # remainder: host scheduling, copy-on-write copies, dispatches the
    # request did not ride). A dispatch's time goes to every request that
    # rode it, and each request's intervals are disjoint.

    def _stamp_admit(self, slot, n_cow: int) -> None:
        """Close the request's queue (first admission) or preempted
        interval and record its segment, with the cached-prefix skip,
        the admission-block attribution and the copy-on-write count."""
        req = slot.request
        now = time.perf_counter()
        if req.preempt_t is not None:
            phase, t_from = "preempted", req.preempt_t
        else:
            phase, t_from = "queue", req.submit_t
        dt = max(now - t_from, 0.0)
        req.phase_s[phase] += dt
        seg = {"ph": phase, "t0": t_from - req.submit_t, "dur": dt}
        if req.trace_id:
            # a traced request's segments say where they ran, and the
            # one closing a migration hold says so: the stitcher splits
            # cross-engine admission wait out of same-engine preemption
            if self.replica is not None:
                seg["replica"] = self.replica
            if req.rid in self._migrate_hold:
                self._migrate_hold.discard(req.rid)
                if phase == "preempted":
                    seg["via"] = "migrate"
                    seg["hop"] = req.hop
        if slot.prefill_pos:
            seg["cached_tokens"] = int(slot.prefill_pos)
        if req.blocked_iters:
            seg["blocked_iters"] = req.blocked_iters
            seg["blocked_reason"] = req.blocked_reason
            req.blocked_iters = 0
        req.segments.append(seg)
        req.preempt_t = None
        req.cow_copies += n_cow

    def _accrue_prefill(self, slot, t0: float, dur: float) -> None:
        """One prefill dispatch's time to a riding slot; consecutive chunks
        coalesce into one segment."""
        req = slot.request
        req.phase_s["prefill"] += dur
        last = req.segments[-1] if req.segments else None
        if last is not None and last["ph"] == "prefill":
            last["dur"] += dur
            last["chunks"] += 1
        else:
            seg = {"ph": "prefill", "t0": t0 - req.submit_t, "dur": dur,
                   "from": int(slot.prefill_pos), "chunks": 1}
            if req.trace_id and self.replica is not None:
                seg["replica"] = self.replica
            req.segments.append(seg)

    def _accrue_decode(self, req: Request, t0: float, dur: float, bucket: int,
                       tokens: int, proposed: int = 0, accepted: int = 0) -> None:
        """One decode dispatch to a riding request; consecutive iterations
        at one width coalesce into one segment (a speculative engine's
        carry the window counts)."""
        req.phase_s["decode"] += dur
        last = req.segments[-1] if req.segments else None
        if last is not None and last["ph"] == "decode" and last["bucket"] == bucket:
            last["dur"] += dur
            last["iters"] += 1
            last["tokens"] += tokens
            if self.speculative:
                last["proposed"] += proposed
                last["accepted"] += accepted
        else:
            seg = {"ph": "decode", "t0": t0 - req.submit_t, "dur": dur,
                   "bucket": int(bucket), "iters": 1, "tokens": tokens}
            if req.trace_id and self.replica is not None:
                seg["replica"] = self.replica
            if self.speculative:
                seg["proposed"] = proposed
                seg["accepted"] = accepted
            req.segments.append(seg)

    def _emit_timeline(self, req: Request, at: str,
                       now: Optional[float] = None) -> None:
        """One ``request_timeline`` event: the five-way decomposition and
        the coalesced segments, at finish or (partial) at preemption."""
        if not (self.timeline and obs.has_sink()):
            return
        end = req.finish_t if at == "finish" else now
        e2e = max(end - req.submit_t, 0.0)
        q, pf = req.phase_s["queue"], req.phase_s["prefill"]
        dc, pe = req.phase_s["decode"], req.phase_s["preempted"]
        segs = [{k: (round(v, 6) if isinstance(v, float) else v)
                 for k, v in s.items()} for s in req.segments]
        fields = {
            "request": req.rid, "at": at,
            "e2e_s": round(e2e, 6),
            "queue_s": round(q, 6),
            "prefill_s": round(pf, 6),
            "decode_s": round(dc, 6),
            "preempted_s": round(pe, 6),
            "overhead_s": round(e2e - (q + pf + dc + pe), 6),
            "tokens": self._generated(req),
            "prompt_len": req.orig_prompt_len,
            "preemptions": req.preemptions,
            "segments": segs,
        }
        if req.ttft_s is not None:
            fields["ttft_s"] = round(req.ttft_s, 6)
        fields.update(self._replica_kw())
        fields.update(self._trace_kw(req))
        if req.group:
            fields["group"] = req.group
        if req.arrival_s is not None:
            fields["arrival_s"] = round(req.arrival_s, 6)
        if at == "finish" and req.slo_met is not None:
            fields["slo_met"] = req.slo_met
            if req.slack_s is not None:
                fields["slack_s"] = req.slack_s
        if req.deadline_s is not None:
            fields["deadline_s"] = req.deadline_s
            if at == "finish" and req.deadline_miss is not None:
                fields["deadline_miss"] = req.deadline_miss
        if req.priority:
            fields["priority"] = req.priority
        if req.cow_copies:
            fields["cow_copies"] = req.cow_copies
        if self.prefix_cache:
            fields["prefix_cached_tokens"] = req.prefix_cached_tokens
        obs.serve("request_timeline", **fields)

    # -- copy-on-write and the host tier ---------------------------------------------

    def _apply_cow(self, slot) -> None:
        """The admission's copy-on-write block copies, in every pool the
        slot's table addresses: the target's (scales included) and the
        draft's."""
        for src, dst in slot.pending_copies:
            self._kv.copy_block(src, dst)
            if self._dkv is not None:
                self._dkv.copy_block(src, dst)
        slot.pending_copies = []

    def _spill_block(self, b: int):
        """The block manager's spill hook: block ``b``'s payload out of
        every pool."""
        return extract_blocks(self._kv.all(), [b], d_pools=self._draft_pools())

    def _swap_out(self, slot) -> bool:
        """The scheduler's preemption hook: extract the victim's resident
        blocks to host instead of recomputing (on committed state: the
        pipeline drained before the capacity phase that chose it). False
        falls back to recompute: policy ``never``/``off``, an ``auto``
        estimate that favors re-prefill, or a full host budget."""
        if self.swap in ("off", "never"):
            return False
        req = slot.request
        n = self.blocks.blocks_for(slot.context_len)
        if n <= 0 or n > len(slot.table):
            return False
        est = n * self._host_block_bytes
        if self.swap == "auto":
            # bytes moved (out now, back at re-admission) against the
            # weight bytes a re-prefill streams (once per chunk dispatch)
            dispatches = -(-slot.context_len // self.sched.prefill_chunk)
            if 2 * est > self._param_bytes * dispatches:
                return False
        if not self.blocks.host_reserve(est):
            return False
        req.swap_set = extract_blocks(self._kv.all(), slot.table[:n],
                                      d_pools=self._draft_pools())
        actual = req.swap_set.nbytes
        if actual != est:
            self.blocks.host_release(est - actual)
        req.swap_context = slot.context_len
        self.swap_outs += 1
        self.swap_bytes_moved += actual
        obs.serve("swap_out", request=req.rid, swap_bytes=actual,
                  **self._replica_kw(), **self._trace_kw(req))
        return True

    def _apply_restores(self, slot) -> None:
        """The admission's host-to-device copies, before any dispatch reads
        the slot's table: a swapped victim's or a hot migrant's block set
        and the prefix blocks revived from the host tier."""
        req = slot.request
        if slot.pending_swap_in is not None:
            bset, slot.pending_swap_in = slot.pending_swap_in, None
            t0 = time.perf_counter()
            insert_blocks(self._kv.all(), bset, slot.table[:bset.n_blocks],
                          d_pools=self._draft_pools())
            dt = time.perf_counter() - t0
            if req.rid in self._migrated_in:
                # a migration arrival: the set came from a sibling's
                # pools, not this engine's host tier (no reservation to
                # release); its traffic is migration traffic
                src_replica = self._migrated_in.pop(req.rid)
                self.migrations_in += 1
                self.migration_bytes += bset.nbytes
                self.migration_restore_s += dt
                kw = {}
                if src_replica is not None:
                    kw["from_replica"] = src_replica
                if self.replica is not None:
                    kw["to_replica"] = self.replica
                kw.update(self._trace_kw(req))
                if req.trace_id and req.migrate_out_t is not None:
                    # the hop's full price, source extraction stamp to
                    # scatter complete; extract_s rides so the stitcher
                    # can split data movement out of the admission wait
                    kw["transport_hop_s"] = round(
                        time.perf_counter() - req.migrate_out_t, 6)
                    kw["extract_s"] = round(req.migrate_extract_s, 6)
                    self.transport_hop_s.append(kw["transport_hop_s"])
                req.migrate_out_t = None
                req.migrate_extract_s = 0.0
                obs.serve("migrate", request=req.rid,
                          migration_bytes=bset.nbytes,
                          restore_s=round(dt, 6), **kw)
            else:
                self.restore_s += dt
                self.blocks.host_release(bset.nbytes)
                self.swap_ins += 1
                self.swap_bytes_moved += bset.nbytes
                self.recompute_tokens_avoided += slot.context_len
                obs.serve("swap_in", request=req.rid, swap_bytes=bset.nbytes,
                          restore_s=round(dt, 6),
                          recompute_tokens_avoided=slot.context_len,
                          **self._replica_kw(), **self._trace_kw(req))
        if slot.pending_restores:
            t0 = time.perf_counter()
            for b, payload in slot.pending_restores:
                insert_blocks(self._kv.all(), payload, [b],
                              d_pools=self._draft_pools())
            self.restore_s += time.perf_counter() - t0
            slot.pending_restores = []

    # -- tokens ----------------------------------------------------------------

    def _generated(self, req: Request) -> int:
        return (len(req.prompt) - req.orig_prompt_len) + len(req.output)

    def _append(self, slot, token: int) -> None:
        req = slot.request
        req.output.append(token)
        now = time.perf_counter()
        if req.first_token_t is None:
            req.first_token_t = now
            obs.serve("first_token", request=req.rid,
                      ttft_s=round(req.ttft_s, 6) if req.ttft_s is not None else None,
                      **self._replica_kw(), **self._trace_kw(req))
        self.tokens_generated += 1
        if (token == self.eos_token_id
                or self._generated(req) >= req.max_new_tokens):
            req.finish_t = now
            self.sched.finish(slot)
            self.finished[req.rid] = req
            extra = {}
            if self.speculative:
                extra = {"speculate_k": self.speculate_k,
                         "draft_proposed": req.spec_proposed,
                         "draft_accepted": req.spec_accepted,
                         "acceptance_rate": (
                             round(req.spec_accepted / req.spec_proposed, 4)
                             if req.spec_proposed else None)}
            if self.prefix_cache:
                extra["prefix_cached_tokens"] = req.prefix_cached_tokens
                extra["cache_hit_rate"] = (round(req.cache_hit_rate, 4)
                                           if req.cache_hit_rate is not None
                                           else None)
            extra["kernel"] = self.kernel
            extra["kv_dtype"] = self.kv_cache_dtype
            extra["tp"] = self.tp
            if req.has_slo:
                extra.update(self._slo_verdict(req))
            if req.deadline_s is not None:
                extra.update(self._deadline_verdict(req))
            obs.serve("finish", request=req.rid, tokens=self._generated(req),
                      preemptions=req.preemptions, **self._replica_kw(),
                      **self._trace_kw(req), **extra)
            self._emit_timeline(req, "finish")

    def _slo_verdict(self, req: Request) -> dict:
        """The request's SLO verdicts at finish: TTFT from its arrival
        (else its submit), TPOT the mean inter-token time after the first
        token, ``slack_s`` the tightest margin (negative on a miss)."""
        origin = req.arrival_s if req.arrival_s is not None else req.submit_t
        margins = []
        if req.slo_ttft_s is not None:
            ttft = ((req.first_token_t - origin)
                    if req.first_token_t is not None else None)
            req.ttft_slo_met = ttft is not None and ttft <= req.slo_ttft_s
            if ttft is not None:
                margins.append(req.slo_ttft_s - ttft)
        if req.slo_tpot_s is not None:
            tokens = self._generated(req)
            tpot = ((req.finish_t - req.first_token_t) / max(tokens - 1, 1)
                    if req.first_token_t is not None else None)
            req.tpot_slo_met = tpot is not None and tpot <= req.slo_tpot_s
            if tpot is not None:
                margins.append(req.slo_tpot_s - tpot)
        req.slo_met = (req.ttft_slo_met is not False
                       and req.tpot_slo_met is not False)
        if margins:
            req.slack_s = round(min(margins), 6)
        self._slo_total += 1
        self._slo_met += int(req.slo_met)
        bucket = self._group_slo.setdefault(req.group, [0, 0])
        bucket[0] += int(req.slo_met)
        bucket[1] += 1
        if self._has_priorities:
            pb = self._priority_slo.setdefault(req.priority, [0, 0])
            pb[0] += int(req.slo_met)
            pb[1] += 1
        out = {"slo_met": req.slo_met}
        if req.ttft_slo_met is not None:
            out["ttft_slo_met"] = req.ttft_slo_met
        if req.tpot_slo_met is not None:
            out["tpot_slo_met"] = req.tpot_slo_met
        if req.slack_s is not None:
            out["slack_s"] = req.slack_s
        return out

    def _deadline_verdict(self, req: Request) -> dict:
        """The end-to-end deadline verdict at finish, from the same origin
        as the SLO verdicts."""
        origin = req.arrival_s if req.arrival_s is not None else req.submit_t
        req.deadline_miss = bool(req.finish_t - origin > req.deadline_s)
        self._deadline_total += 1
        self._deadline_miss += int(req.deadline_miss)
        return {"deadline_miss": req.deadline_miss}

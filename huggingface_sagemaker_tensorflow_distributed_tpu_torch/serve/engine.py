"""Continuous-batching serving engine for GPT-2 over paged KV pools — the
serial loop of the JAX package's ``serve/engine.py``.

Each :meth:`ServeEngine.step` admits waiting requests (FIFO), runs
batched chunked prefill under the scheduler's token budget, grows the
decode slots' block tables (preempting by recompute when the pool runs
dry), then runs one decode step over every slot:

- prefill packs up to ``prefill_batch`` prefilling slots' chunks into
  one ``[G, C]`` dispatch against a dense per-row cache gathered from
  the pools, then scatters the chunk's K/V back into the pools;
- decode feeds every slot's last token through the model's paged
  branch: the new K/V is scattered into the pools and attention walks
  the block tables directly (the CUDA kernel on the card, which reads
  ``ceil(ctx / block_size)`` blocks per slot). Inactive slots write the
  reserved null block 0 at context 0.

The next token is the argmax of the fp32 logits, or, when any active
slot samples, ``models/generate.py::sample_per_slot`` over the rows
(greedy rows stay the raw argmax): a sampled request's n-th token is
drawn with noise that is a function of (its seed, n), so recompute
preemption re-derives the same stream. ``kv_cache_dtype='int8'`` keeps
the pools in int8 with fp32 scale pools beside them (one scale per
(token, head)); prefill quantizes as the dense int8 cache does and the
decode kernel dequantizes. ``kv_pool_bytes`` sizes the pool by bytes,
scales counted, so int8 pools hold more blocks, and admit more requests,
than fp pools of the same bytes.

Not ported yet: the gather-width bucket ladder, the prefix cache,
speculation, dispatch-ahead overlap, tensor parallelism, swap, admission
policies and telemetry.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import resolve_device
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.generate import (
    sample_per_slot,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.kv_cache import (
    DenseCache,
    PagedCache,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.attention import (
    gather_paged_kv,
    scatter_paged_kv,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.paged_kv import (
    BlockManager,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.scheduler import (
    Request,
    Scheduler,
)


class EngineStats(NamedTuple):
    decode_steps: int
    prefill_chunks: int
    prefill_dispatches: int
    tokens_generated: int
    decode_tokens: int
    decode_time_s: float
    preemptions: int
    kv_peak_utilization: float
    kv_utilization: float
    paged_kernel_launches: int
    peak_resident_requests: int = 0


ENV_KV_DTYPE = "HSTD_SERVE_KV_DTYPE"


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


def percentile(sorted_vals: list, p: float) -> float:
    """Nearest-rank percentile over an already sorted list (the JAX
    package's ``obs/report.py`` convention)."""
    n = len(sorted_vals)
    return float(sorted_vals[min(n - 1, int(p * (n - 1) + 0.5))])


class ServeEngine:
    """Continuous-batching engine over a
    :class:`~..models.gpt2.Gpt2LMHeadModel` that lives on ``device``
    (CUDA unless the caller names another; raises without it).

    ``num_blocks`` includes the reserved null block: allocatable KV is
    ``(num_blocks - 1) * block_size`` tokens shared by every request;
    ``kv_pool_bytes`` instead sizes it from a byte budget. ``prefill_batch``
    caps how many prefilling slots one prefill dispatch packs.
    ``kv_cache_dtype`` (``fp`` | ``int8``; default ``HSTD_SERVE_KV_DTYPE``
    or the model config's) picks the pools' storage."""

    def __init__(self, model, *, num_slots: int = 8, block_size: int = 16,
                 num_blocks: int = 129, prefill_chunk: int = 16,
                 max_model_len: Optional[int] = None, prefill_batch: int = 4,
                 kv_cache_dtype: Optional[str] = None,
                 kv_pool_bytes: Optional[int] = None, device=None):
        cfg = model.config
        self.device = resolve_device(device)
        if model.backbone.wte.weight.device.type != self.device.type:
            raise ValueError(f"model lives on {model.backbone.wte.weight.device}"
                             f", engine asked for {self.device}")
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
        heads, head_dim = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        # bytes one resident token costs across every pool, an int8
        # pool's fp32 scale plane included
        per_head = head_dim * (1 if int8 else torch.tensor([], dtype=cfg.dtype).element_size())
        token_bytes = 2 * cfg.num_layers * heads * (per_head + (4 if int8 else 0))
        if kv_pool_bytes is not None:
            num_blocks = max(2, 1 + int(kv_pool_bytes) // (block_size * token_bytes))
        self.blocks = BlockManager(num_blocks, block_size,
                                   token_bytes=token_bytes)
        self.sched = Scheduler(self.num_slots, self.blocks, prefill_chunk,
                               self.max_model_len)
        self.max_blocks_per_seq = self.max_model_len // block_size
        self.prefill_batch = max(1, min(int(prefill_batch), self.num_slots))

        def pools(dim, dtype):
            return [torch.zeros(num_blocks, block_size, heads, dim,
                                dtype=dtype, device=self.device)
                    for _ in range(cfg.num_layers)]

        store = torch.int8 if int8 else cfg.dtype
        self.k_pools, self.v_pools = pools(head_dim, store), pools(head_dim, store)
        self.k_scale_pools = pools(1, torch.float32) if int8 else None
        self.v_scale_pools = pools(1, torch.float32) if int8 else None
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
        self.paged_kernel_launches = 0

    # -- requests -----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 0.0, seed: int = 0) -> Request:
        """Queue one request: greedy at ``temperature=0``, else sampled
        (``top_k`` / ``top_p`` truncation, 0 disables each) from ``seed``."""
        req = Request(prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature), top_k=int(top_k),
                      top_p=float(top_p), seed=int(seed))
        req.submit_t = time.perf_counter()
        self.sched.submit(req)
        return req

    def output_ids(self, req: Request) -> np.ndarray:
        """Generated ids (preemption-folded tokens included)."""
        folded = req.prompt[req.orig_prompt_len:]
        return np.concatenate(
            [folded, np.asarray(req.output, np.int32)]).astype(np.int32)

    def run(self) -> dict[int, Request]:
        """Step until every submitted request finished; {rid: Request}."""
        while self.sched.has_work():
            self.step()
        return self.finished

    # -- reports ------------------------------------------------------------

    def stats(self) -> EngineStats:
        return EngineStats(
            decode_steps=self.decode_steps,
            prefill_chunks=self.prefill_chunks,
            prefill_dispatches=self.prefill_dispatches,
            tokens_generated=self.tokens_generated,
            decode_tokens=self.decode_tokens,
            decode_time_s=self.decode_time_s,
            preemptions=self.sched.n_preemptions,
            kv_peak_utilization=self.blocks.peak_used
            / max(self.blocks.num_blocks - 1, 1),
            kv_utilization=self.blocks.utilization(),
            paged_kernel_launches=self.paged_kernel_launches,
            peak_resident_requests=self.peak_resident)

    def slo_summary(self) -> dict:
        """TTFT / end-to-end latency percentiles and scheduler gauges over
        every finished request ({} until one finishes)."""
        reqs = list(self.finished.values())
        if not reqs:
            return {}
        out = {
            "requests": len(reqs),
            "tokens": self.tokens_generated,
            "iterations": self.iterations,
            "preemptions": self.sched.n_preemptions,
            "peak_waiting_depth": self.peak_waiting,
            "peak_resident_requests": self.peak_resident,
            "kv_peak_utilization": round(
                self.blocks.peak_used / max(self.blocks.num_blocks - 1, 1), 4),
        }
        if self.decode_time_s > 0:
            out["decode_tokens_per_sec"] = round(
                self.decode_tokens / self.decode_time_s, 1)
        ttfts = [r.ttft_s for r in reqs if r.ttft_s is not None]
        e2es = [r.finish_t - r.submit_t for r in reqs
                if r.finish_t is not None and r.submit_t is not None]
        for label, vals in (("ttft", ttfts), ("e2e", e2es)):
            if not vals:
                continue
            s = sorted(vals)
            out[f"{label}_p50_s"] = round(percentile(s, 0.50), 6)
            out[f"{label}_p95_s"] = round(percentile(s, 0.95), 6)
            out[f"{label}_p99_s"] = round(percentile(s, 0.99), 6)
        return out

    # -- one iteration ------------------------------------------------------

    @torch.inference_mode()
    def step(self) -> None:
        """Admit, batched prefill under the token budget, decode-side
        block capacity (preempting if needed), one decode step."""
        self.sched.admit()
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
        self.sched.ensure_decode_capacity()
        self._decode_all()
        self.peak_waiting = max(self.peak_waiting, len(self.sched.waiting))
        self.iterations += 1

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _pools(self):
        """(dense cache field, pools) pairs: K and V, and their scale
        pools under int8."""
        pairs = [("keys", self.k_pools), ("values", self.v_pools)]
        if self.k_scale_pools is not None:
            pairs += [("key_scales", self.k_scale_pools),
                      ("value_scales", self.v_scale_pools)]
        return pairs

    def _pick(self, logits: torch.Tensor, rows: list) -> np.ndarray:
        """The next token of each row of ``logits`` [R, V] on the host:
        the argmax, or ``sample_per_slot`` when a row's request samples.
        ``rows`` holds ``(row, request)`` for the rows that emit."""
        if not any(req.sampled for _, req in rows):
            return logits.argmax(-1).cpu().numpy()
        R = logits.shape[0]
        temps = np.zeros(R, np.float32)
        top_ks = np.zeros(R, np.int64)
        top_ps = np.zeros(R, np.float32)
        seeds = np.zeros(R, np.int64)
        folds = np.zeros(R, np.int64)
        for i, req in rows:
            temps[i], top_ks[i], top_ps[i] = req.temperature, req.top_k, req.top_p
            # the request-global index of the token drawn
            seeds[i], folds[i] = req.seed, self._generated(req)
        return sample_per_slot(logits.float(), self._tensor(temps), self._tensor(top_ks),
                               self._tensor(top_ps), self._tensor(seeds),
                               self._tensor(folds)).cpu().numpy()

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
        nb = self.max_blocks_per_seq
        chunks = np.full((G, C), self.pad_token_id, np.int64)
        tables = np.zeros((G, nb), np.int32)
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
        chunks_t, tables_t = self._tensor(chunks), self._tensor(tables)
        start_t, rel_t = self._tensor(start), self._tensor(rel)
        # the rows' dense caches (int8 with their scales), gathered over
        # the full table width
        dense = {field: [gather_paged_kv(p, tables_t) for p in pools]
                 for field, pools in self._pools()}
        cache = DenseCache(keys=dense["keys"], values=dense["values"],
                           key_scales=dense.get("key_scales"),
                           value_scales=dense.get("value_scales"), index=start_t)
        max_ctx = nb * self.blocks.block_size
        offsets = torch.arange(C, device=self.device)
        # the chunk's slots are valid; the model's step mask imposes
        # causality inside the chunk, and pad-tail keys sit after every
        # real query
        valid = (torch.arange(max_ctx, device=self.device)[None, :]
                 < start_t[:, None] + C).long()
        positions = start_t[:, None] + offsets[None, :]        # [G, C]
        logits = self.model(chunks_t, valid, positions, cache)
        rows = torch.arange(G, device=self.device)
        last = logits[rows, rel_t.clamp(0, C - 1)]
        # scatter the written chunk K/V (and scales) back into the pools
        flat_pos = positions.reshape(-1)
        tables_tok = tables_t.repeat_interleave(C, dim=0)      # [G*C, nb]
        for field, pools in self._pools():
            for buf, pool in zip(getattr(cache, field), pools):
                written = buf[rows[:, None], :, positions]     # [G, C, H, D]
                scatter_paged_kv(pool, tables_tok, flat_pos,
                                 written.reshape(G * C, *written.shape[2:]))
        for slot in slots:
            slot.prefill_pos += C
        self.prefill_chunks += len(slots)
        self.prefill_dispatches += 1
        if finals:
            tok_host = self._pick(last, [(i, slot.request) for i, slot in finals])
            for i, slot in finals:
                self.sched.finish_prefill(slot)
                self._append(slot, int(tok_host[i]))
        return G

    def _decode_all(self) -> None:
        ds = self.sched.decode_slots()
        if not ds:
            return
        S = self.num_slots
        tokens = np.zeros((S,), np.int64)
        tables = np.zeros((S, self.max_blocks_per_seq), np.int32)
        ctx = np.zeros((S,), np.int32)
        for slot in ds:
            tokens[slot.index] = slot.request.output[-1]
            tables[slot.index, :len(slot.table)] = slot.table
            ctx[slot.index] = slot.context_len
        t0 = time.perf_counter()
        launches0 = paged_decode_attention.launches
        cache = PagedCache(self.k_pools, self.v_pools, self.k_scale_pools,
                           self.v_scale_pools, self._tensor(tables), self._tensor(ctx))
        ctx_t = cache.context_lens.long()
        logits = self.model(self._tensor(tokens)[:, None], None,
                            ctx_t[:, None], cache)
        nxt = self._pick(logits[:, -1], [(slot.index, slot.request) for slot in ds])
        self.paged_kernel_launches += paged_decode_attention.launches - launches0
        self.decode_time_s += time.perf_counter() - t0
        self.decode_steps += 1
        self.decode_tokens += len(ds)
        for slot in ds:
            slot.context_len += 1        # the fed token's K/V landed
            self._append(slot, int(nxt[slot.index]))

    def _generated(self, req: Request) -> int:
        return (len(req.prompt) - req.orig_prompt_len) + len(req.output)

    def _append(self, slot, token: int) -> None:
        req = slot.request
        req.output.append(token)
        now = time.perf_counter()
        if req.first_token_t is None:
            req.first_token_t = now
        self.tokens_generated += 1
        if (token == self.eos_token_id
                or self._generated(req) >= req.max_new_tokens):
            req.finish_t = now
            self.sched.finish(slot)
            self.finished[req.rid] = req

"""Serving entry point of the PyTorch port: drive :class:`ServeEngine`
over a request trace and report per-request latency and aggregate
throughput (the port of the JAX package's ``scripts/serve.py``).

Requests come from ``--input_file`` (JSONL, one ``{"prompt_ids": [...],
"max_new_tokens": N}`` per line, optionally with ``temperature``,
``top_k``, ``top_p`` and ``seed``) or a synthetic mixed-length trace.
``--temperature`` / ``--top_k`` / ``--top_p`` / ``--sample_seed`` set every
request's default sampling (greedy at temperature 0, the default).
``--model_dir`` serves a GPT-2 export (``model.safetensors`` +
``config.json``, e.g. the training CLI's causal-LM export); without it the
model is a GPT-2 with random weights from ``--seed``: ``--model smoke``
(the default) is the small shape ``scripts/serve.py`` serves, ``--model
gpt2`` is GPT-2 124M at full width. ``--kv_cache_dtype int8`` keeps the KV
pools in int8 with fp32 scales. Runs on the GPU unless ``--device cpu`` is
given.

  python -m huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.cli \\
      --requests 32 --num_slots 8 --block_size 16 --prefill_chunk 16 \\
      --temperature 0.8 --top_p 0.9 --kv_cache_dtype int8

One JSON line per finished request, then one summary line whose keys
are a subset of ``scripts/serve.py``'s plus ``paged_kernel_launches``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import resolve_device
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    init_gpt2,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import (
    Gpt2Config,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.paged_attention import (
    load_kernel,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import (
    ServeEngine,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.trace import (
    make_trace,
)

SMOKE_CONFIG = dict(vocab_size=1024, hidden_size=256, num_layers=4,
                    num_heads=4, intermediate_size=1024,
                    max_position_embeddings=512, eos_token_id=1023,
                    pad_token_id=0)


def model_config(name: str) -> Gpt2Config:
    """``smoke``: ``scripts/serve.py``'s small GPT-2; ``gpt2``: GPT-2 124M."""
    kw = SMOKE_CONFIG if name == "smoke" else {}
    return Gpt2Config(hidden_dropout=0.0, embd_dropout=0.0,
                      attention_dropout=0.0, **kw)


def _sampling_kw(row: dict, defaults: dict, where: str) -> dict:
    """A JSONL row's sampling fields over the CLI's defaults (null or
    absent: the default), refusing a non-number or a fractional integer
    field with its line, as ``scripts/serve.py`` does."""
    kw = {}
    for k, default in defaults.items():
        raw = row.get(k)
        if raw is None:
            kw[k] = default
            continue
        if isinstance(raw, bool) or not isinstance(raw, (int, float)):
            raise SystemExit(f"serve: {where}: field {k!r} must be a number, got {raw!r}")
        if isinstance(default, int) and raw != int(raw):
            raise SystemExit(f"serve: {where}: field {k!r} must be an integer, got {raw!r}")
        kw[k] = type(default)(raw)
    return kw


def load_trace(args, vocab: int):
    """[(prompt_ids, max_new_tokens, sampling kwargs)] from the JSONL
    file or the synthetic trace."""
    defaults = {"temperature": args.temperature, "top_k": args.top_k,
                "top_p": args.top_p, "seed": args.sample_seed}
    if args.input_file:
        trace = []
        with open(args.input_file, "r", encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                if not line.strip():
                    continue
                row = json.loads(line)
                kw = _sampling_kw(row, defaults, f"{args.input_file}:{lineno}")
                trace.append((np.asarray(row["prompt_ids"], np.int32),
                              int(row.get("max_new_tokens", args.max_new_tokens)), kw))
        return trace
    rng = np.random.RandomState(args.seed)
    base = make_trace(rng, args.requests, vocab, args.prompt_min,
                      args.prompt_max, (4, max(4, args.max_new_tokens // 4)),
                      (args.max_new_tokens // 2, args.max_new_tokens),
                      long_every=4)
    return [(p, m, dict(defaults)) for p, m in base]


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="smoke", choices=("smoke", "gpt2"))
    parser.add_argument("--model_dir", default=None,
                        help="a GPT-2 export to serve (else random weights)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--input_file", default=None,
                        help="JSONL of {prompt_ids, max_new_tokens}")
    parser.add_argument("--requests", type=int, default=32,
                        help="synthetic-trace request count")
    parser.add_argument("--prompt_min", type=int, default=8)
    parser.add_argument("--prompt_max", type=int, default=48)
    parser.add_argument("--max_new_tokens", type=int, default=64)
    parser.add_argument("--num_slots", type=int, default=8)
    parser.add_argument("--block_size", type=int, default=16)
    parser.add_argument("--num_blocks", type=int, default=0,
                        help="KV pool blocks incl. the null block "
                             "(0 = 3/4 of slots * max_model_len)")
    parser.add_argument("--prefill_chunk", type=int, default=16)
    parser.add_argument("--prefill_batch", type=int, default=4,
                        help="max prefilling slots packed per dispatch")
    parser.add_argument("--max_model_len", type=int, default=0,
                        help="0 = model max_position_embeddings")
    parser.add_argument("--kv_cache_dtype", default=None, choices=("fp", "int8"),
                        help="KV pool storage (default: HSTD_SERVE_KV_DTYPE "
                             "or the model config)")
    parser.add_argument("--temperature", type=float, default=0.0,
                        help="0 = greedy (the default); > 0 samples")
    parser.add_argument("--top_k", type=int, default=0)
    parser.add_argument("--top_p", type=float, default=0.0)
    parser.add_argument("--sample_seed", type=int, default=0,
                        help="per-request sampling seed default")
    parser.add_argument("--seed", type=int, default=0)
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.model_dir:
        model, _, cfg = auto.from_pretrained(args.model_dir, task="causal-lm",
                                             device=device)
        model.requires_grad_(False)
    else:
        cfg = model_config(args.model)
        model = init_gpt2(cfg, seed=args.seed, device=device)
    max_len = args.max_model_len or (
        cfg.max_position_embeddings // args.block_size) * args.block_size
    num_blocks = args.num_blocks or (
        1 + args.num_slots * (max_len // args.block_size) * 3 // 4)
    engine = ServeEngine(model, num_slots=args.num_slots,
                         block_size=args.block_size, num_blocks=num_blocks,
                         prefill_chunk=args.prefill_chunk,
                         prefill_batch=args.prefill_batch,
                         max_model_len=max_len, kv_cache_dtype=args.kv_cache_dtype,
                         device=device)
    if device.type == "cuda":
        load_kernel()                 # build before the clock starts
    trace = load_trace(args, cfg.vocab_size - 1)
    reqs = [engine.submit(p, m, **kw) for p, m, kw in trace]
    t0 = time.perf_counter()
    engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    total = 0
    for req in reqs:
        ids = engine.output_ids(req)
        total += len(ids)
        print(json.dumps({
            "request": req.rid, "prompt_len": req.orig_prompt_len,
            "output_ids": [int(t) for t in ids],
            "ttft_s": round(req.ttft_s, 4) if req.ttft_s else None,
            "preemptions": req.preemptions}))
    stats = engine.stats()
    slo = engine.slo_summary()
    print(json.dumps({
        "summary": True,
        "requests": len(reqs),
        "tokens": total,
        "tokens_per_sec": round(total / wall, 1),
        "ttft_p50_s": slo.get("ttft_p50_s"),
        "ttft_p95_s": slo.get("ttft_p95_s"),
        "ttft_p99_s": slo.get("ttft_p99_s"),
        "e2e_p50_s": slo.get("e2e_p50_s"),
        "e2e_p95_s": slo.get("e2e_p95_s"),
        "e2e_p99_s": slo.get("e2e_p99_s"),
        "peak_waiting_depth": slo.get("peak_waiting_depth"),
        "decode_steps": stats.decode_steps,
        "decode_tokens_per_sec": slo.get("decode_tokens_per_sec"),
        "prefill_chunks": stats.prefill_chunks,
        "prefill_dispatches": stats.prefill_dispatches,
        "preemptions": stats.preemptions,
        "kernel": "cuda" if device.type == "cuda" else "plain",
        "kv_dtype": engine.kv_cache_dtype,
        "kv_pool_bytes_per_device": engine.blocks.pool_bytes,
        "kv_peak_utilization": round(stats.kv_peak_utilization, 3),
        "paged_kernel_launches": stats.paged_kernel_launches}))


if __name__ == "__main__":
    main()

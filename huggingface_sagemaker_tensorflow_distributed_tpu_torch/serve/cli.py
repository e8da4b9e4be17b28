"""Serving entry point of the PyTorch port: drive :class:`ServeEngine`
over a request trace and report per-request latency and aggregate
throughput (the port of the JAX package's ``scripts/serve.py``).

Requests come from ``--input_file`` (JSONL, one ``{"prompt_ids": [...],
"max_new_tokens": N}`` per line) or a synthetic mixed-length trace.
Decoding is greedy. The model is a GPT-2 with random weights from
``--seed``: ``--model smoke`` (the default) is the small shape
``scripts/serve.py`` serves, ``--model gpt2`` is GPT-2 124M at full
width. Runs on the GPU unless ``--device cpu`` is given.

  python -m huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.cli \\
      --requests 32 --num_slots 8 --block_size 16 --prefill_chunk 16

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


def load_trace(args, vocab: int):
    """[(prompt_ids, max_new_tokens)] from the JSONL file or the
    synthetic trace."""
    if args.input_file:
        trace = []
        with open(args.input_file, "r", encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                row = json.loads(line)
                trace.append((np.asarray(row["prompt_ids"], np.int32),
                              int(row.get("max_new_tokens",
                                          args.max_new_tokens))))
        return trace
    rng = np.random.RandomState(args.seed)
    return make_trace(rng, args.requests, vocab, args.prompt_min,
                      args.prompt_max, (4, max(4, args.max_new_tokens // 4)),
                      (args.max_new_tokens // 2, args.max_new_tokens),
                      long_every=4)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="smoke", choices=("smoke", "gpt2"))
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
    parser.add_argument("--seed", type=int, default=0)
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
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
                         max_model_len=max_len, device=device)
    if device.type == "cuda":
        load_kernel()                 # build before the clock starts
    trace = load_trace(args, cfg.vocab_size - 1)
    reqs = [engine.submit(p, m) for p, m in trace]
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
        "kv_dtype": cfg.kv_cache_dtype,
        "kv_pool_bytes_per_device": engine.blocks.pool_bytes,
        "kv_peak_utilization": round(stats.kv_peak_utilization, 3),
        "paged_kernel_launches": stats.paged_kernel_launches}))


if __name__ == "__main__":
    main()

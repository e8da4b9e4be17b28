#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port
(``huggingface_sagemaker_tensorflow_distributed_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (built for an H100: ``sm_90a``) and ``nvcc``.
Imports nothing of JAX or of the JAX package. Phases, in order; any
failure raises and exits non-zero:

1. environment: the card's name and power limit (``nvidia-smi``), the
   CUDA version; TF32 off for matmuls and cuDNN;
2. kernel: builds ``csrc/paged_attention.cu`` and holds the paged
   decode kernel against ``paged_decode_attention_reference`` on random
   pools with scrambled block tables, ragged contexts including 0 and a
   ``width`` below the table span (GPT-2 shapes, GQA, a sliding window,
   int8 pools, bf16, block sizes 4 and 8). fp32 and int8 must agree to
   ``atol = rtol = 1e-4`` on active rows, bf16 to ``2e-2``; context-0
   rows must be exactly 0. Prints one JSON line per case with the
   kernel's, the plain version's and ``scaled_dot_product_attention``'s
   time (CUDA events, inputs rotated over four copies so the working
   set exceeds the 50 MB L2), and the bandwidth/compute bound;
3. serve: ``ServeEngine`` on GPT-2 124M at full width (fp32, random
   weights from seed 0) over 20 requests, 16 from ``make_trace`` with
   ``scripts/serve.py``'s defaults and 4 with 512-896-token prompts.
   Requires ``paged_kernel_launches == decode_steps * num_layers`` and
   the engine's tokens equal to the plain ``generate_causal`` on the
   card, up to the first step where the plain path's top-2 logit gap is
   below 1e-3 (a near-tie, counted and printed);
4. profile: the same trace on a fresh engine under ``torch.profiler``,
   printing device time by kernel and the device's idle share;
5. the ``kernels`` line, the card's line, and the final
   ``{"ok": true, "device": ...}`` line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "huggingface_sagemaker_tensorflow_distributed_tpu_torch"
KERNEL_SOURCE = f"{PKG}/csrc/paged_attention.cu"
KERNEL_REPLACES = ("huggingface_sagemaker_tensorflow_distributed_tpu/ops/"
                   "pallas_paged_attention.py:67")
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and fp32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
NEAR_TIE = 1e-3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# -- phase 1 -----------------------------------------------------------------

def env_phase() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    check(bool(smi), "nvidia-smi printed no card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "card": smi[0], "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    return smi[0]


# -- phase 2 -----------------------------------------------------------------

KERNEL_CASES = [
    # name, slots, Hq, Hkv, D, block_size, max context, dtype, int8, window
    ("gpt2", 8, 12, 12, 64, 16, 1024, "float32", False, None),
    ("gqa", 8, 32, 8, 128, 16, 1024, "float32", False, None),
    ("window64", 8, 12, 12, 64, 16, 1024, "float32", False, 64),
    ("int8", 8, 12, 12, 64, 16, 1024, "float32", True, None),
    ("bf16", 8, 12, 12, 64, 16, 1024, "bfloat16", False, None),
    ("int8_bf16", 8, 32, 8, 128, 16, 1024, "bfloat16", True, None),
    ("bs4_gqa", 4, 8, 2, 128, 4, 200, "float32", False, 24),
    ("bs8", 4, 12, 12, 64, 8, 300, "float32", False, None),
]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
COPIES = 4          # distinct input sets the timing rotates over


def _contexts(S: int, max_ctx: int, gen) -> list[int]:
    """Ragged contexts: one 0, one full, the rest random in [1, max)."""
    import torch

    rest = torch.randint(1, max_ctx, (S - 2,), generator=gen).tolist()
    return [0, max_ctx] + rest


def _make_inputs(case, gen, device):
    import torch

    name, S, Hq, Hkv, D, bs, max_ctx, dt, int8, window = case
    dtype = getattr(torch, dt)
    nb_walk = -(-max_ctx // bs)
    nb_table = nb_walk + 4                       # width stays below the span
    N = 1 + S * nb_table
    tables = (torch.randperm(N - 1, generator=gen) + 1)[: S * nb_table]
    tables = tables.reshape(S, nb_table).to(torch.int32)
    ctx = torch.tensor(_contexts(S, max_ctx, gen), dtype=torch.int32)
    q = torch.randn(S, Hq, D, generator=gen).to(dtype)
    if int8:
        k = torch.randint(-127, 128, (N, bs, Hkv, D), generator=gen).to(torch.int8)
        v = torch.randint(-127, 128, (N, bs, Hkv, D), generator=gen).to(torch.int8)
        ks = torch.rand(N, bs, Hkv, 1, generator=gen) * 0.02 + 1e-3
        vs = torch.rand(N, bs, Hkv, 1, generator=gen) * 0.02 + 1e-3
    else:
        k = torch.randn(N, bs, Hkv, D, generator=gen).to(dtype)
        v = torch.randn(N, bs, Hkv, D, generator=gen).to(dtype)
        ks = vs = None
    t = dict(q=q, k_pool=k, v_pool=v, block_tables=tables, context_lens=ctx,
             k_scale_pool=ks, v_scale_pool=vs)
    t = {key: (val.to(device) if val is not None else None)
         for key, val in t.items()}
    return t, dict(width=nb_walk * bs, window=window)


def _work(case, ctx: list[int]) -> tuple[int, int]:
    """(bytes, flops) the function needs for these contexts: q and out
    once, each valid key's K and V row once (plus its scales), the
    table entries walked and the context lengths."""
    name, S, Hq, Hkv, D, bs, max_ctx, dt, int8, window = case
    esz = 2 if dt == "bfloat16" else 4
    kv_esz = 1 if int8 else esz
    width = -(-max_ctx // bs) * bs
    spans = [(max(0, c - window) if window else 0, min(c, width)) for c in ctx]
    keys = sum(max(0, hi - lo) for lo, hi in spans)
    table_entries = sum(max(0, -(-hi // bs) - lo // bs) for lo, hi in spans)
    bytes_ = (2 * S * Hq * D * esz                   # q in, out
              + keys * Hkv * (2 * D * kv_esz + (8 if int8 else 0))
              + table_entries * 4 + S * 4)
    flops = keys * Hq * D * 4                        # q.k and p.v
    return bytes_, flops


def _cuda_ms(fn, arg_sets, iters: int = 40) -> float:
    import torch

    for i in range(3):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _sdpa_inputs(t, opts):
    """The same attention as dense tensors for one
    ``scaled_dot_product_attention`` call: gathered (dequantized, GQA
    repeated) KV and a boolean context/band mask. Built outside the
    timed call."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.attention import (
        gather_paged_kv,
    )

    q = t["q"]
    k = gather_paged_kv(t["k_pool"], t["block_tables"], opts["width"])
    v = gather_paged_kv(t["v_pool"], t["block_tables"], opts["width"])
    if t["k_scale_pool"] is not None:
        k = (k.float() * gather_paged_kv(t["k_scale_pool"], t["block_tables"],
                                         opts["width"])).to(q.dtype)
        v = (v.float() * gather_paged_kv(t["v_scale_pool"], t["block_tables"],
                                         opts["width"])).to(q.dtype)
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).contiguous()
    v = v.repeat_interleave(rep, dim=1).contiguous()
    pos = torch.arange(k.shape[2], device=q.device)[None, :]
    ctx = t["context_lens"].long()[:, None]
    keep = pos < ctx
    if opts["window"]:
        keep = keep & (pos > ctx - 1 - opts["window"])
    keep[:, 0] |= ~keep.any(-1)          # context-0 rows: any finite row
    return q[:, :, None, :], k, v, keep[:, None, None, :]


def kernel_phase() -> dict:
    import torch
    import torch.nn.functional as F

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import _build
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.paged_attention import (
        load_kernel,
        paged_decode_attention,
        paged_decode_attention_reference,
    )

    t0 = time.perf_counter()
    load_kernel()
    emit({"phase": "build", "library": str(_build.library_path("paged_attention")
                                           .relative_to(ROOT)),
          "seconds": round(time.perf_counter() - t0, 3)})
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    results = {}
    for case in KERNEL_CASES:
        name, dt = case[0], case[7]
        sets = [_make_inputs(case, gen, dev) for _ in range(COPIES)]
        t, opts = sets[0]
        got = paged_decode_attention(**t, **opts)
        want = paged_decode_attention_reference(**t, **opts)
        torch.cuda.synchronize()
        ctx = t["context_lens"].cpu()
        act = ctx > 0
        g, w = got.float().cpu(), want.float().cpu()
        err = float((g[act] - w[act]).abs().max())
        tol = TOL[dt]
        ok = (torch.allclose(g[act], w[act], atol=tol, rtol=tol)
              and bool((g[~act] == 0).all()) and bool(torch.isfinite(g).all()))
        check(ok, f"kernel case {name}: max_abs_err {err} (tol {tol}) or a "
                  "context-0 row is not exactly 0")
        args = [tuple(s[0].values()) + (s[1]["width"], s[1]["window"]) for s in sets]

        def kern(q, kp, vp, bt, cl, ksp, vsp, width, window):
            paged_decode_attention(q, kp, vp, bt, cl, width=width, window=window,
                                   k_scale_pool=ksp, v_scale_pool=vsp)

        def plain(q, kp, vp, bt, cl, ksp, vsp, width, window):
            paged_decode_attention_reference(q, kp, vp, bt, cl, width=width,
                                             window=window, k_scale_pool=ksp,
                                             v_scale_pool=vsp)

        dense = [_sdpa_inputs(*s) for s in sets]
        ms = _cuda_ms(kern, args)
        plain_ms = _cuda_ms(plain, args)
        library_ms = _cuda_ms(
            lambda q, k, v, m: F.scaled_dot_product_attention(q, k, v, attn_mask=m),
            dense)
        nbytes, flops = _work(case, ctx.tolist())
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        row = {"phase": "kernel", "case": name, "slots": case[1], "hq": case[2],
               "hkv": case[3], "head_dim": case[4], "block_size": case[5],
               "dtype": dt, "int8": case[8], "window": case[9],
               "contexts": ctx.tolist(), "width": opts["width"],
               "max_abs_err": err, "tol": tol, "status": "pass",
               "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "flops": flops}
        emit(row)
        results[name] = row
        del sets, dense, args
    return results


# -- phase 3 -----------------------------------------------------------------

def serve_trace():
    import numpy as np

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.trace import (
        make_trace,
    )

    rng = np.random.RandomState(0)
    vocab = 50257 - 1
    # scripts/serve.py's synthetic defaults: prompts 8-48, max_new 64
    trace = make_trace(rng, 16, vocab, 8, 48, (4, 16), (32, 64), long_every=4)
    for _ in range(4):              # long prompts: decode walks up to 60 blocks
        p = int(rng.randint(512, 897))
        trace.append((rng.randint(1, vocab, (p,)).astype(np.int32),
                      int(rng.randint(32, 65))))
    return trace


def serve_engine(model):
    """The serve phase's engine: 8 slots, block 16, chunk 16, prefill
    batch 4, max_model_len 1024 and ``scripts/serve.py``'s default pool
    of 3/4 of slots x max_model_len."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import (
        ServeEngine,
    )

    max_len, bs, slots = 1024, 16, 8
    return ServeEngine(model, num_slots=slots, block_size=bs,
                       num_blocks=1 + slots * (max_len // bs) * 3 // 4,
                       prefill_chunk=16, prefill_batch=4,
                       max_model_len=max_len, device="cuda")


def serve_phase() -> tuple[dict, object, list]:
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
        init_gpt2,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.generate import (
        generate_causal,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import (
        Gpt2Config,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
    )

    cfg = Gpt2Config(hidden_dropout=0.0, embd_dropout=0.0, attention_dropout=0.0)
    model = init_gpt2(cfg, seed=0, device="cuda")
    engine = serve_engine(model)
    trace = serve_trace()
    reqs = [engine.submit(p, m) for p, m in trace]
    paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_decode_attention.launches
    stats = engine.stats()
    check(stats.decode_steps > 0 and launches > 0, "no decode step ran the kernel")
    check(launches == stats.decode_steps * cfg.num_layers
          and stats.paged_kernel_launches == launches,
          f"paged_kernel_launches {launches} != decode_steps "
          f"{stats.decode_steps} x {cfg.num_layers}")
    check(len(engine.finished) == len(trace), "not every request finished")

    near_ties = 0
    compared = 0
    t1 = time.perf_counter()
    for (prompt, max_new), req in zip(trace, reqs):
        got = [int(x) for x in engine.output_ids(req)]
        ids, scores = generate_causal(model, torch.as_tensor(prompt)[None],
                                      max_new_tokens=max_new, output_scores=True)
        check(bool(torch.isfinite(scores).all()), f"request {req.rid}: "
              "non-finite logits on the plain path")
        ref = ids[0].tolist()
        if cfg.eos_token_id in ref:
            ref = ref[:ref.index(cfg.eos_token_id) + 1]
        top2 = scores[0, :len(ref)].topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        n = next((i for i, gp in enumerate(gaps) if gp < NEAR_TIE), len(ref))
        if n < len(ref):
            near_ties += 1
        # tokens must agree through the first near-tie step inclusive of
        # everything before it; after it the paths may legitimately split
        check(len(got) == len(ref) or n < len(ref),
              f"request {req.rid}: engine emitted {len(got)} tokens, plain "
              f"path {len(ref)}")
        check(got[:n] == ref[:n], f"request {req.rid}: engine tokens differ "
              f"from plain generate_causal before any near-tie "
              f"(engine {got[:n]}, plain {ref[:n]})")
        compared += n
    plain_s = time.perf_counter() - t1
    slo = engine.slo_summary()
    tokens = sum(len(engine.output_ids(r)) for r in reqs)
    row = {"phase": "serve", "model": "gpt2-124m", "layers": cfg.num_layers,
           "hidden": cfg.hidden_size, "vocab": cfg.vocab_size, "dtype": "float32",
           "requests": len(reqs), "tokens": tokens,
           "tokens_per_sec": tokens / wall, "wall_s": wall,
           "ttft_p50_s": slo.get("ttft_p50_s"), "ttft_p99_s": slo.get("ttft_p99_s"),
           "e2e_p50_s": slo.get("e2e_p50_s"), "e2e_p99_s": slo.get("e2e_p99_s"),
           "decode_steps": stats.decode_steps,
           "decode_tokens_per_sec": slo.get("decode_tokens_per_sec"),
           "prefill_dispatches": stats.prefill_dispatches,
           "preemptions": stats.preemptions,
           "kv_peak_utilization": stats.kv_peak_utilization,
           "paged_kernel_launches": launches,
           "tokens_compared_with_plain": compared, "near_ties": near_ties,
           "plain_generate_s": plain_s}
    emit(row)
    return row, model, trace


def profile_phase(model, trace, serve_wall_s: float) -> dict:
    """The serve trace once more, on a fresh engine under
    ``torch.profiler`` (device activity only): device time by kernel, the
    paged kernel's share, and the device's idle share of the counted
    serve run's wall time (the same work, unprofiled). Runs after the
    counted serve run; its launches are not the main path's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine = serve_engine(model)
    for prompt, max_new in trace:
        engine.submit(prompt, max_new)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e6
    busy = sum(by_kernel.values())
    paged = sum(v for k, v in by_kernel.items() if "paged_decode_kernel" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    row = {"phase": "profile", "profiled_wall_s": wall,
           "serve_wall_s": serve_wall_s,
           "device_busy_s": busy if busy else "not measured",
           "idle_share": 1.0 - busy / serve_wall_s if busy else "not measured",
           "paged_kernel_s": paged, "paged_kernel_share_of_busy":
           paged / busy if busy else "not measured",
           "decode_steps": engine.decode_steps,
           "top_kernels_s": [[k[:80], v] for k, v in top]}
    emit(row)
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (ROOT / PKG / "__init__.py").is_file():
        print(f"chip_smoke: {PKG} not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    card = env_phase()
    kernels = kernel_phase()
    serve, model, trace = serve_phase()
    profile_phase(model, trace, serve["wall_s"])
    main_case = kernels["gpt2"]
    emit({"kernels": [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": serve["paged_kernel_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kernels.values()
                           if r["dtype"] == "float32"),
        "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "status": {name: r["status"] for name, r in kernels.items()}}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

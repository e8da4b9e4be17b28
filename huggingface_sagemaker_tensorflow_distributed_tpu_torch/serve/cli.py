"""Serving entry point of the PyTorch port: drive a fleet of
:class:`ServeEngine` replicas behind a :class:`~.router.Router` over a
request trace and report per-request latency and aggregate throughput
(the port of the JAX package's ``scripts/serve.py``).

Requests come from ``--input_file`` (JSONL, one ``{"prompt_ids": [...],
"max_new_tokens": N}`` per line, optionally with ``temperature``,
``top_k``, ``top_p`` and ``seed``) or a synthetic mixed-length trace.
``--temperature`` / ``--top_k`` / ``--top_p`` / ``--sample_seed`` set every
request's default sampling (greedy at temperature 0, the default).
``--model_dir`` serves a GPT-2 or dense Llama-family export
(``model.safetensors`` + ``config.json``, e.g. the training CLI's
causal-LM export; a directory with ``config.json`` alone gives random
weights from seed 0, as the JAX CLI's does); without it the
model is a GPT-2 with random weights from ``--seed``: ``--model smoke``
(the default) is the small shape ``scripts/serve.py`` serves, ``--model
gpt2`` is GPT-2 124M at full width. ``--kv_cache_dtype int8`` keeps the KV
pools in int8 with fp32 scales. The engine's knobs are ``scripts/serve.py``'s,
each defaulting to its ``HSTD_SERVE_*`` variable: ``--gather_buckets``
(the decode width ladder, ``full`` for one width), ``--speculate_k`` and
``--draft_layers`` (speculative decoding with a self-draft), ``--prefix_cache
on|off``, ``--kernel pallas|xla`` (the K3 route, the port's default, or the
gather route), ``--timeline on|off``, ``--overlap on|off`` (dispatch-ahead),
``--slo ttft:SECS[,tpot:SECS]``, ``--policy fifo|slo`` and ``--aging_s``,
``--swap auto|always|never|off`` and ``--swap_bytes``. Every run is built
through the router: ``--replicas N`` engines (one, the default, is the
bare engine's run), ``--placement round_robin|least_loaded|affinity``,
``--roles prefill:N,decode:M`` (a disaggregated fleet), ``--rate_limit
GROUP=RATE[:BURST],...`` (per-tenant token buckets); ``--arrival
poisson:RATE|bursty:HI,LO,P`` submits the trace on that open-loop
schedule (seed ``HSTD_SERVE_ARRIVAL_SEED``) on the wall clock. Runs on
the GPU unless ``--device cpu`` is given.

``--tp N`` (``HSTD_SERVE_TP``, default 1) serves tensor-parallel: one engine
whose weights and KV pools (on their heads axis: ``num_kv_heads % N == 0``)
are cut over N ranks, token-identical to the single-device engine, so one
``--kv_pool_bytes`` buys about N times the residents. The CLI is then started
once per rank, with the same arguments, by ``torchrun`` or the port's
launcher (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``, or the JAX
package's ``TPU_*`` triplet; one card a rank). Rank 0 serves and prints the
rows and the summary, both with ``tp`` (the summary also
``kv_pool_bytes_per_device``); the other ranks follow it and print nothing.
``--replicas`` above 1 (or ``--roles``) with ``--tp`` above 1 is not ported
(ROADMAP queue 1, item 11):

  torchrun --nproc_per_node 2 -m \
      huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.cli --tp 2

  python -m huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.cli \\
      --requests 32 --num_slots 8 --block_size 16 --prefill_chunk 16 \\
      --temperature 0.8 --top_p 0.9 --kv_cache_dtype int8 --swap always

One JSON line per finished request (with its ``replica`` on a fleet),
then one summary line whose keys are ``scripts/serve.py``'s (the
single-engine or the fleet summary) plus ``paged_kernel_launches``.
With ``HSTD_TELEMETRY_DIR`` set, the engine's ``serve`` events and spans
go there.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs, resolve_device
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    init_gpt2,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import (
    Gpt2Config,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.distributed import (
    initialize_distributed,
    local_device,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import parse_tp
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.loadgen import (
    OpenLoopDriver,
    bursty_arrivals,
    parse_arrival,
    parse_arrival_seed,
    parse_slo,
    poisson_arrivals,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.router import (
    Router,
    parse_replicas,
    parse_roles,
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
    parser.add_argument("--gather_buckets", default=None,
                        help="decode width ladder, e.g. '64,256' ('full': one "
                             "width; default: HSTD_SERVE_GATHER_BUCKETS or a "
                             "quarter plus the full width)")
    parser.add_argument("--speculate_k", type=int, default=None,
                        help="speculative decoding: draft tokens per verify "
                             "window (default: HSTD_SERVE_SPECULATE_K or 0)")
    parser.add_argument("--draft_layers", type=int, default=None,
                        help="self-draft depth (default: "
                             "HSTD_SERVE_DRAFT_LAYERS or a quarter of the "
                             "target's layers)")
    parser.add_argument("--prefix_cache", default=None, choices=("on", "off"),
                        help="copy-on-write prompt-prefix sharing (default: "
                             "HSTD_SERVE_PREFIX_CACHE or on)")
    parser.add_argument("--kernel", default=None, choices=("xla", "pallas"),
                        help="decode route: pallas = the paged decode kernel "
                             "(K3 on the card), xla = gather + dense "
                             "attention (default: HSTD_SERVE_KERNEL or pallas)")
    parser.add_argument("--timeline", default=None, choices=("on", "off"),
                        help="per-request lifecycle tracing (default: "
                             "HSTD_SERVE_TIMELINE or on)")
    parser.add_argument("--overlap", default=None, choices=("on", "off"),
                        help="dispatch-ahead decode loop (default: "
                             "HSTD_SERVE_OVERLAP or on)")
    parser.add_argument("--slo", default=None,
                        help="per-request targets, ttft:SECS[,tpot:SECS] or "
                             "none (default: HSTD_SERVE_SLO_TTFT_S / "
                             "HSTD_SERVE_SLO_TPOT_S)")
    parser.add_argument("--policy", default=None, choices=("fifo", "slo"),
                        help="admission order (default: HSTD_SERVE_POLICY or "
                             "fifo)")
    parser.add_argument("--aging_s", type=float, default=None,
                        help="starvation bound of --policy slo (default: "
                             "HSTD_SERVE_AGING_S or 30)")
    parser.add_argument("--swap", default=None,
                        choices=("auto", "always", "never", "off"),
                        help="host KV tier: swap preemption victims, demote "
                             "evicted prefix blocks (default: HSTD_SERVE_SWAP "
                             "or off)")
    parser.add_argument("--swap_bytes", type=int, default=None,
                        help="host tier byte budget (default: "
                             "HSTD_SERVE_SWAP_BYTES or 0 = unbounded)")
    parser.add_argument("--replicas", type=int, default=None,
                        help="engine replicas behind the placement router, "
                             "token-identical to one engine (default: "
                             "HSTD_SERVE_REPLICAS or 1)")
    parser.add_argument("--placement", default=None,
                        choices=("round_robin", "least_loaded", "affinity"),
                        help="replica placement (default: "
                             "HSTD_SERVE_PLACEMENT or round_robin)")
    parser.add_argument("--roles", default=None,
                        help="disaggregated fleet, prefill:N,decode:M "
                             "(default: HSTD_SERVE_ROLES or mixed replicas)")
    parser.add_argument("--arrival", default=None,
                        help="open-loop arrivals, poisson:RATE or "
                             "bursty:RATE_HI,RATE_LO,P_SWITCH, or closed "
                             "(default: HSTD_SERVE_ARRIVAL or closed; seed: "
                             "HSTD_SERVE_ARRIVAL_SEED)")
    parser.add_argument("--rate_limit", default=None,
                        help="per-tenant token buckets, "
                             "GROUP=RATE[:BURST],... ('*' = the default "
                             "bucket); over-budget submits are rejected, "
                             "counted in rate_limited")
    parser.add_argument("--tp", type=int, default=None,
                        help="tensor-parallel degree: one engine's weights and "
                             "KV pools cut over this many ranks, one process "
                             "each (default: HSTD_SERVE_TP or 1)")
    parser.add_argument("--temperature", type=float, default=0.0,
                        help="0 = greedy (the default); > 0 samples")
    parser.add_argument("--top_k", type=int, default=0)
    parser.add_argument("--top_p", type=float, default=0.0)
    parser.add_argument("--sample_seed", type=int, default=0,
                        help="per-request sampling seed default")
    parser.add_argument("--seed", type=int, default=0)
    return parser.parse_args(argv)


def _refuse_unported(args, tp: int, roles) -> None:
    """A fleet of tensor-parallel replicas is not ported: the control
    channel would have to say which engine each operation belongs to."""
    if tp > 1 and (parse_replicas(args.replicas) > 1 or roles is not None):
        raise NotImplementedError(
            f"--tp {tp} with --replicas/--roles (a fleet of tensor-parallel "
            "replicas) is not ported yet: ROADMAP queue 1, item 11")


def _open_loop(router, trace, arrival, seed: int, slo_spec):
    """The trace on the ``arrival`` schedule through the wall-clock
    driver (``arrival_s`` and the SLO go into every submit)."""
    proc, pp = arrival
    if proc == "poisson":
        arrivals = poisson_arrivals(pp["rate"], len(trace), seed)
        rate = pp["rate"]
    else:
        arrivals = bursty_arrivals(pp["rate_hi"], pp["rate_lo"],
                                   pp["p_switch"], len(trace), seed)
        rate = pp["rate_hi"]
    schedule = [(a, {"prompt": p, "max_new_tokens": m, **kw})
                for a, (p, m, kw) in zip(arrivals, trace)]
    return OpenLoopDriver(router, schedule, clock="wall", slo=slo_spec,
                          process=proc, rate=rate)


def _fleet_summary(router, reqs, total: int, wall: float) -> dict:
    """``scripts/serve.py``'s fleet summary: the router's aggregate and
    the engines' summed counters."""
    engine = router.engines[0]
    rslo = router.slo_summary()
    stats_all = [e.stats() for e in router.engines]
    return {
        "summary": True,
        "requests": len(reqs),
        "tokens": total,
        "tokens_per_sec": round(total / wall, 1),
        "replicas": router.n,
        "placement": router.placement,
        "drains": router.drains,
        "requeues": router.requeues,
        "replica_load_imbalance": rslo.get("replica_load_imbalance"),
        "affinity_fallbacks": (router.affinity_fallbacks
                               if router.placement == "affinity" else None),
        "ttft_p50_s": rslo.get("ttft_p50_s"),
        "ttft_p95_s": rslo.get("ttft_p95_s"),
        "ttft_p99_s": rslo.get("ttft_p99_s"),
        "e2e_p50_s": rslo.get("e2e_p50_s"),
        "e2e_p95_s": rslo.get("e2e_p95_s"),
        "e2e_p99_s": rslo.get("e2e_p99_s"),
        "peak_waiting_depth": rslo.get("peak_waiting_depth"),
        "decode_steps": sum(s.decode_steps for s in stats_all),
        "decode_tokens_per_sec": rslo.get("decode_tokens_per_sec"),
        "prefill_chunks": sum(s.prefill_chunks for s in stats_all),
        "preemptions": sum(s.preemptions for s in stats_all),
        "gather_buckets": engine.gather_buckets,
        "prefix_cache": engine.prefix_cache,
        "cache_hit_rate": rslo.get("cache_hit_rate"),
        "timeline": engine.timeline,
        "overlap": engine.overlap,
        "kernel": engine.kernel,
        "kv_dtype": engine.kv_cache_dtype,
        "tp": engine.tp,
        "per_replica": rslo.get("per_replica"),
        **({"roles": rslo.get("roles"),
            "per_role": rslo.get("per_role"),
            "migrations": router.migrations,
            "migration_bytes": sum(s.migration_bytes for s in stats_all)}
           if router.roles is not None else {}),
        **({"swap_policy": engine.swap,
            "swap_outs": sum(s.swap_outs for s in stats_all),
            "swap_ins": sum(s.swap_ins for s in stats_all),
            "swap_bytes": sum(s.swap_bytes for s in stats_all),
            "recompute_tokens_avoided": sum(
                s.recompute_tokens_avoided for s in stats_all),
            "host_tier_hits": sum(s.host_tier_hits for s in stats_all)}
           if engine.swap != "off" else {}),
        **({"policy": router.policy,
            "aging_promotions": rslo.get("aging_promotions")}
           if router.policy != "fifo" else {}),
        **({"deadline_miss_frac": rslo.get("deadline_miss_frac")}
           if rslo.get("deadline_miss_frac") is not None else {}),
        **({"priority_slo_attainment": rslo.get("priority_slo_attainment")}
           if rslo.get("priority_slo_attainment") else {}),
    }


def main(argv=None) -> None:
    args = parse_args(argv)
    try:
        tp = parse_tp(args.tp)
        arrival = parse_arrival(args.arrival)
        arrival_seed = parse_arrival_seed()
        slo_spec = parse_slo(args.slo)
        roles = parse_roles(args.roles)
    except ValueError as e:
        raise SystemExit(f"serve: {e}")
    _refuse_unported(args, tp, roles)
    device = resolve_device(args.device)
    if tp > 1:
        # one process a rank, each with its own card (or the CPU's gloo)
        initialize_distributed(device.type)
        device = local_device(device.type)
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
    # one construction path: a one-replica router is the bare engine
    router = Router(model, replicas=args.replicas, placement=args.placement,
                    roles=roles, num_slots=args.num_slots,
                    block_size=args.block_size, num_blocks=num_blocks,
                    prefill_chunk=args.prefill_chunk,
                    prefill_batch=args.prefill_batch,
                    max_model_len=max_len,
                    gather_buckets=args.gather_buckets,
                    speculate_k=args.speculate_k, draft=args.draft_layers,
                    prefix_cache=args.prefix_cache, kernel=args.kernel,
                    kv_cache_dtype=args.kv_cache_dtype,
                    timeline=args.timeline, overlap=args.overlap,
                    swap=args.swap, swap_bytes=args.swap_bytes,
                    policy=args.policy, aging_s=args.aging_s,
                    rate_limit=args.rate_limit, mesh=tp, device=device)
    engine = router.engines[0]
    if not engine.is_leader:
        engine.follow()
        return
    trace = load_trace(args, cfg.vocab_size - 1)
    # builds K3 before the clock starts
    router.warmup(sampled=any(kw.get("temperature", 0) > 0 for _, _, kw in trace))
    driver = None
    rejected = 0
    if arrival is not None:
        driver = _open_loop(router, trace, arrival, arrival_seed, slo_spec)
        t0 = time.perf_counter()
        finished = driver.run()
        reqs = [finished[rid] for rid in sorted(finished)]
    else:
        reqs = []
        for p, m, kw in trace:
            r = router.submit(p, m, slo=slo_spec, **kw)
            if getattr(r, "rejected", False):
                rejected += 1
            else:
                reqs.append(r)
        t0 = time.perf_counter()
        router.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    total = 0
    for req in reqs:
        ids = router.output_ids(req)
        total += len(ids)
        row = {"request": req.rid, "prompt_len": req.orig_prompt_len,
               "output_ids": [int(t) for t in ids],
               "ttft_s": round(req.ttft_s, 4) if req.ttft_s else None,
               "sampled": req.sampled, "seed": req.seed,
               "preemptions": req.preemptions, "tp": engine.tp}
        if req.has_slo:
            row["slo_met"] = req.slo_met
            row["slack_s"] = req.slack_s
        if req.deadline_s is not None:
            row["deadline_s"] = req.deadline_s
            row["deadline_miss"] = req.deadline_miss
        if req.priority:
            row["priority"] = req.priority
        if router.n > 1:
            row["replica"] = router.replica_of(req)
        if engine.speculative:
            row["acceptance_rate"] = (round(req.spec_accepted / req.spec_proposed, 4)
                                      if req.spec_proposed else None)
        if engine.prefix_cache:
            row["prefix_cached_tokens"] = req.prefix_cached_tokens
        if engine.timeline:
            row["phase_s"] = {ph: round(v, 4) for ph, v in req.phase_s.items()}
        print(json.dumps(row))
    # the open loop's goodput accounting (absent on a closed run)
    open_extra = {}
    if slo_spec is not None:
        open_extra["slo"] = {"ttft_s": slo_spec.ttft_s, "tpot_s": slo_spec.tpot_s}
    if driver is not None:
        dsum = driver.summary()
        open_extra["arrival"] = {"process": dsum["process"], "rate": dsum.get("rate"),
                                 "seed": arrival_seed, "clock": dsum["clock"]}
        for k in ("slo_attainment", "slo_met", "slo_missed", "goodput_tokens",
                  "group_slo_attainment", "miss_phases", "dominant_miss_phase",
                  "rate_limited", "deadline_misses", "deadline_miss_frac"):
            if k in dsum:
                open_extra[k] = dsum[k]
    elif rejected:
        open_extra["rate_limited"] = rejected
    launches = sum(e.paged_kernel_launches for e in router.engines)
    engine.close()
    if router.n > 1:
        rslo = router.slo_summary()
        print(json.dumps({
            **_fleet_summary(router, reqs, total, wall),
            **({"arrival_backlog_peak": rslo.get("arrival_backlog_peak")}
               if driver is not None else {}),
            **({"slo_attainment": rslo.get("slo_attainment"),
                "group_slo_attainment": rslo.get("group_slo_attainment")}
               if slo_spec is not None and driver is None else {}),
            **open_extra,
            "paged_kernel_launches": launches}))
        obs.flush()
        return
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
        "gather_buckets": engine.gather_buckets,
        "bucket_switches": stats.bucket_switches,
        "gather_read_waste_peak": round(stats.gather_waste_peak, 3),
        "gather_read_waste_mean": round(stats.gather_waste_mean, 3),
        "speculate_k": engine.speculate_k or None,
        "acceptance_rate": (round(stats.acceptance_rate, 4)
                            if stats.acceptance_rate is not None else None),
        "verify_read_waste_mean": (round(stats.verify_waste_mean, 3)
                                   if engine.speculative else None),
        "prefix_cache": engine.prefix_cache,
        "cache_hit_rate": (round(stats.cache_hit_rate, 4)
                           if stats.cache_hit_rate is not None else None),
        "blocks_shared_peak": (stats.blocks_shared_peak
                               if engine.prefix_cache else None),
        "blocks_saved_peak": (stats.blocks_saved_peak
                              if engine.prefix_cache else None),
        "cow_copies": stats.cow_copies if engine.prefix_cache else None,
        "timeline": engine.timeline,
        "queue_wait_p99_s": slo.get("queue_wait_p99_s"),
        "queue_time_frac": slo.get("queue_time_frac"),
        "prefill_time_frac": slo.get("prefill_time_frac"),
        "decode_time_frac": slo.get("decode_time_frac"),
        "preempted_time_frac": slo.get("preempted_time_frac"),
        "overhead_time_frac": slo.get("overhead_time_frac"),
        "overlap": engine.overlap,
        "overlap_flushes": stats.overlap_flushes if engine.overlap else None,
        "kernel": stats.kernel,
        "kv_dtype": stats.kv_dtype,
        "tp": stats.tp,
        "kv_pool_bytes_per_device": stats.kv_pool_bytes_per_device or None,
        "kv_bytes_read_per_step": (round(stats.kv_bytes_read / stats.decode_steps, 1)
                                   if stats.decode_steps else None),
        "kv_peak_utilization": round(stats.kv_peak_utilization, 3),
        **({"swap_policy": stats.swap_policy,
            "swap_outs": stats.swap_outs,
            "swap_ins": stats.swap_ins,
            "swap_bytes": stats.swap_bytes,
            "restore_s": round(stats.restore_s, 6),
            "recompute_tokens_avoided": stats.recompute_tokens_avoided,
            "host_tier_hits": stats.host_tier_hits,
            "host_tier_hit_rate": (round(stats.host_tier_hit_rate, 4)
                                   if stats.host_tier_hit_rate is not None
                                   else None)}
           if engine.swap != "off" else {}),
        **({"arrival_backlog_peak": slo.get("arrival_backlog_peak")}
           if driver is not None else {}),
        **({"slo_attainment": slo.get("slo_attainment"),
            "group_slo_attainment": slo.get("group_slo_attainment")}
           if slo_spec is not None and driver is None else {}),
        **({"policy": engine.policy,
            "aging_promotions": slo.get("aging_promotions")}
           if engine.policy != "fifo" else {}),
        **({"deadline_miss_frac": slo.get("deadline_miss_frac")}
           if slo.get("deadline_miss_frac") is not None else {}),
        **({"priority_slo_attainment": slo.get("priority_slo_attainment")}
           if slo.get("priority_slo_attainment") else {}),
        **open_extra,
        "paged_kernel_launches": stats.paged_kernel_launches}))
    obs.flush()


if __name__ == "__main__":
    main()

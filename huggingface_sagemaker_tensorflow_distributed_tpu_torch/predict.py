"""Inference entry point of the PyTorch port: load an exported checkpoint
and predict (the port of the JAX package's ``scripts/predict.py``, with
its flags, refusals and one JSON row per input with the same keys).

  python -m huggingface_sagemaker_tensorflow_distributed_tpu_torch.predict \\
      --model_dir /path/to/export --task seq-cls --text "a great movie"
  ... --task qa --text "who wrote it?" --context "it was written by Ada."
  ... --task seq2seq --text "summarize: ..." --max_new_tokens 48 --num_beams 4
  ... --task causal-lm --text "once upon a time" --temperature 0.8 --top_p 0.9
  ... --task causal-lm --text "once upon a time" --self_speculate_layers 4
  ... --task causal-lm --text "once upon a time" --quantize int8 --kv_cache int8
  ... --task mlm --text "the capital of france is [MASK]"

Each input line (``--text``/``--context``, or ``--input_file`` JSONL of
``{"text": ..., "context"?: ...}``) gives one JSON line on stdout. The
model is built as ``auto.from_pretrained`` builds it from the export (the
config's own attention, fp32); ``--adapter`` merges a LoRA sidecar at
load; ``--quantize int8`` makes the generation models' denses int8
weight-only (``models/quant.py``). Runs on the GPU unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import resolve_device
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
    load_tokenizer,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import generate as gen


def _encode_mlm_with_mask(tokenizer, texts, max_length, mask_id):
    """Texts holding literal "[MASK]" markers for tokenizers that do not
    read the token inline: tokenize the segments around each marker and
    splice the mask id between them."""
    cls_id = getattr(tokenizer, "cls_token_id", None)
    sep_id = getattr(tokenizer, "sep_token_id", None)
    pad_id = getattr(tokenizer, "pad_token_id", 0)
    rows = []
    for text in texts:
        row = [cls_id] if cls_id is not None else []
        parts = text.split("[MASK]")
        for i, part in enumerate(parts):
            if part.strip():
                seg = tokenizer([part], add_special_tokens=False, max_length=max_length)
                am = np.asarray(seg["attention_mask"][0])
                row += [int(x) for x in np.asarray(seg["input_ids"][0])[am > 0]]
            if i < len(parts) - 1:
                row.append(int(mask_id))
        if sep_id is not None:
            row.append(sep_id)
        if int(mask_id) not in row[:max_length] and int(mask_id) in row:
            print(f"warning: [MASK] in {text[:40]!r} fell past "
                  f"--max_seq_length {max_length} and was truncated away",
                  file=sys.stderr)
        rows.append(row[:max_length])
    width = max(len(r) for r in rows)
    ids = np.full((len(rows), width), pad_id, np.int32)
    am = np.zeros((len(rows), width), np.int32)
    for r, row in enumerate(rows):
        ids[r, : len(row)] = row
        am[r, : len(row)] = 1
    return {"input_ids": ids, "attention_mask": am}


def _encode(tokenizer, texts, contexts, max_length):
    if contexts is not None:
        return tokenizer(texts, text_pairs=contexts, max_length=max_length, padding="longest")
    return tokenizer(texts, max_length=max_length, padding="longest")


def _generate(args, model, ids, mask, device):
    """[rows, max_new_tokens] ids of the generation tasks, refusing the
    flag combinations the JAX script refuses."""
    if args.self_speculate_layers and args.task != "causal-lm":
        raise SystemExit("--self_speculate_layers (layer-skip "
                         "self-speculation) supports --task "
                         "causal-lm only; seq2seq speculation needs "
                         "a separate --draft_dir checkpoint")
    if args.prefill_chunk:
        if args.task != "causal-lm":
            raise SystemExit("--prefill_chunk supports --task causal-lm only")
        if args.draft_dir or args.self_speculate_layers:
            raise SystemExit("--prefill_chunk cannot combine with "
                             "speculative decoding (its prefill is "
                             "not chunked)")
        if args.num_beams > 1:
            raise SystemExit("--prefill_chunk cannot combine with "
                             "--num_beams (beam prefill is not "
                             "chunked)")
    if args.task == "seq2seq":
        if args.draft_dir:
            if args.num_beams > 1 or args.top_k or args.top_p:
                raise SystemExit(
                    "--draft_dir for seq2seq supports greedy and "
                    "plain --temperature sampling only (no beams, "
                    "no top-k/top-p)")
            draft, _, _ = auto.from_pretrained(args.draft_dir, task="seq2seq", device=device)
            return gen.generate_speculative_seq2seq(
                model, draft, ids, mask, max_new_tokens=args.max_new_tokens,
                speculate_k=args.speculate_k, temperature=args.temperature, seed=args.seed)
        if args.num_beams > 1:
            return gen.beam_search_generate(model, ids, mask, num_beams=args.num_beams,
                                            max_new_tokens=args.max_new_tokens,
                                            length_penalty=args.length_penalty)
        return gen.generate(model, ids, mask, max_new_tokens=args.max_new_tokens,
                            temperature=args.temperature, top_k=args.top_k,
                            top_p=args.top_p, seed=args.seed)
    if args.draft_dir or args.self_speculate_layers:
        # token-exact greedy at temperature 0, the target's distribution
        # above it; knobs it cannot honor are refused
        spec_flag = "--draft_dir" if args.draft_dir else "--self_speculate_layers"
        if (args.top_k or args.top_p) and not args.temperature:
            raise SystemExit(
                f"{spec_flag}: --top_k/--top_p need --temperature "
                "> 0 (greedy speculation is argmax, which filtering "
                "cannot change)")
        if args.num_beams > 1:
            raise SystemExit(f"{spec_flag} cannot combine with "
                             "--num_beams (speculative decode is "
                             "greedy)")
        if args.self_speculate_layers < 0:
            raise SystemExit("--self_speculate_layers must be >= 1")
        if args.draft_dir and args.self_speculate_layers:
            raise SystemExit("--draft_dir and --self_speculate_layers "
                             "are mutually exclusive")
        if args.self_speculate_layers:
            draft = gen.self_draft(model, args.self_speculate_layers)
        else:
            draft, _, _ = auto.from_pretrained(args.draft_dir, task="causal-lm",
                                               device=device)
        # prompt widths bucketed to multiples of 32 (right-padded masks),
        # one batched call per bucket
        ids_np, mask_np = ids.cpu().numpy(), mask.cpu().numpy()
        widths = [min(ids_np.shape[1], ((int(mask_np[r].sum()) + 31) // 32) * 32)
                  for r in range(ids_np.shape[0])]
        rows = [None] * ids_np.shape[0]
        for w in sorted(set(widths)):
            sel = [r for r, rw in enumerate(widths) if rw == w]
            outs = gen.generate_speculative(
                model, draft, ids_np[sel][:, :w], mask_np[sel][:, :w],
                max_new_tokens=args.max_new_tokens, speculate_k=args.speculate_k,
                temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
                seed=args.seed).cpu().numpy()
            for i, r in enumerate(sel):
                rows[r] = outs[i]
        return np.stack(rows, axis=0)
    if args.num_beams > 1:
        if args.temperature or args.top_k or args.top_p:
            raise SystemExit("--num_beams is deterministic beam "
                             "search; it cannot combine with "
                             "--temperature/--top_k/--top_p")
        return gen.beam_search_causal(model, ids, mask, num_beams=args.num_beams,
                                      max_new_tokens=args.max_new_tokens,
                                      length_penalty=args.length_penalty)
    return gen.generate_causal(model, ids, mask, max_new_tokens=args.max_new_tokens,
                               temperature=args.temperature, top_k=args.top_k,
                               top_p=args.top_p, seed=args.seed,
                               prefill_chunk=args.prefill_chunk)


def predict(args) -> list[dict]:
    device = resolve_device(args.device)
    overrides = {}
    if args.kv_cache != "fp":
        if args.task != "causal-lm":
            raise SystemExit("--kv_cache int8 is a decode-cache knob "
                             "(Llama family + GPT-2); use --task "
                             "causal-lm")
        overrides["kv_cache_dtype"] = args.kv_cache
    model, _, config = auto.from_pretrained(args.model_dir, task=args.task,
                                            num_labels=args.num_labels, device=device,
                                            **overrides)
    model.eval().requires_grad_(False)
    tokenizer = load_tokenizer(args.model_dir, vocab_size=config.vocab_size)

    if args.adapter:
        from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.lora import (
            load_adapters,
            lora_scaling,
            merge_lora,
        )

        lora, meta = load_adapters(args.adapter, device=device)
        model.load_state_dict(merge_lora(model, lora, lora_scaling(meta["lora_rank"],
                                                                   meta["lora_alpha"])))
        print(f"adapter: r={meta['lora_rank']} alpha={meta['lora_alpha']} "
              f"targets={meta['lora_targets']} merged", file=sys.stderr)

    if args.quantize == "int8":
        if args.task not in ("causal-lm", "seq2seq"):
            raise SystemExit("--quantize int8 covers the generation tasks "
                             "(--task causal-lm or seq2seq)")
        from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.quant import (
            quantize_for_generation,
        )

        model, stats = quantize_for_generation(model)
        print(f"int8: {stats['kernels_quantized']} kernels, "
              f"{stats['bytes_before']/1e6:.1f} -> "
              f"{stats['bytes_after']/1e6:.1f} MB", file=sys.stderr)

    if args.input_file:
        with open(args.input_file) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        texts = [r["text"] for r in rows]
        contexts = ([r.get("context", "") for r in rows]
                    if any("context" in r for r in rows) else None)
    else:
        texts = [args.text]
        contexts = [args.context] if args.context else None

    max_len = min(args.max_seq_length,
                  getattr(config, "max_position_embeddings", args.max_seq_length))
    qa_offsets = None
    if args.task == "qa" and contexts is not None and hasattr(tokenizer, "encode_qa"):
        # the eval metric's encoding: only-second truncation plus char
        # offsets, trimmed to the longest real row
        enc = dict(tokenizer.encode_qa(texts, contexts, max_length=max_len,
                                       return_offsets=True, doc_stride=args.doc_stride))
        width = max(int(np.asarray(enc["attention_mask"]).sum(1).max()), 1)
        enc = {k: v[:, :width] if getattr(v, "ndim", 1) == 2 else v for k, v in enc.items()}
        qa_offsets = (enc["offset_starts"], enc["offset_ends"])
        qa_example_ids = enc.get("example_ids")
    else:
        enc = _encode(tokenizer, texts, contexts, max_len)

    def tensor(a):
        return torch.as_tensor(np.asarray(a), device=device).long()

    ids, mask = tensor(enc["input_ids"]), tensor(enc["attention_mask"])
    token_types = tensor(enc["token_type_ids"]) if "token_type_ids" in enc else None

    results: list[dict] = []
    if args.task in ("seq2seq", "causal-lm"):
        out = _generate(args, model, ids, mask, device)
        for text, row in zip(texts, np.asarray(torch.as_tensor(out).cpu())):
            results.append({"text": text, "generated": tokenizer.decode(row),
                            "generated_ids": row.tolist()})
        return results

    def apply(i, m, t):
        with torch.inference_mode():
            return model(i, m, token_type_ids=t)

    out = apply(ids, mask, token_types)
    am = mask.cpu().numpy()
    ids_np = ids.cpu().numpy()
    if args.task == "seq-cls":
        probs = torch.softmax(out.float(), -1).cpu().numpy()
        for text, p in zip(texts, probs):
            results.append({"text": text, "label": int(p.argmax()),
                            "probs": [round(float(x), 4) for x in p]})
    elif args.task == "token-cls":
        pred = out.argmax(-1).cpu().numpy()
        for r, text in enumerate(texts):
            results.append({"text": text,
                            "tokens": tokenizer.convert_ids_to_tokens(ids_np[r][am[r] > 0]),
                            "labels": pred[r][am[r] > 0].tolist()})
    elif args.task == "qa":
        start, end = (x.float().cpu().numpy() for x in out)
        if qa_offsets is not None:
            # the eval metric's decode: the joint best span over context
            # tokens, sliced from the original context
            from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.metrics import (
                extract_answer_spans,
            )

            ex_ids = qa_example_ids if qa_example_ids is not None else np.arange(len(texts))
            feat_ctx = [contexts[int(ex)] for ex in ex_ids]
            spans = extract_answer_spans(start, end, qa_offsets[0], qa_offsets[1], feat_ctx,
                                         with_spans=True, with_scores=True)
            # doc-stride: each input's highest-scoring window
            best = {}
            for (answer, s_tok, e_tok, score), ex in zip(spans, ex_ids):
                ex = int(ex)
                if ex not in best or score > best[ex][3]:
                    best[ex] = (answer, s_tok, e_tok, score)
            for r, text in enumerate(texts):
                answer, s_tok, e_tok, _ = best[r]
                results.append({"text": text, "start": s_tok, "end": e_tok,
                                "answer": answer})
        else:
            s, e = start.argmax(-1), end.argmax(-1)
            for r, text in enumerate(texts):
                lo, hi = int(s[r]), int(e[r])
                span_ids = ids_np[r][lo: hi + 1] if hi >= lo else []
                results.append({"text": text, "start": lo, "end": hi,
                                "answer": tokenizer.decode(span_ids)})
    elif args.task == "rtd":
        probs = torch.sigmoid(out.float()).cpu().numpy()
        for r, text in enumerate(texts):
            results.append({"text": text,
                            "tokens": tokenizer.convert_ids_to_tokens(ids_np[r][am[r] > 0]),
                            "replaced_prob": [round(float(x), 4)
                                              for x in probs[r][am[r] > 0]]})
    elif args.task == "mlm":
        mask_id = getattr(tokenizer, "mask_token_id", None)
        if mask_id is None:
            raise ValueError(
                "mlm prediction needs a tokenizer with a mask token "
                "(tokenizer.mask_token_id is None); same loud-failure "
                "convention as ArrayDataset.from_mlm_texts")
        if not np.any(ids_np == mask_id):
            # in-repo tokenizers split a literal "[MASK]" into punctuation
            enc = _encode_mlm_with_mask(tokenizer, texts, max_len, mask_id)
            ids_np = np.asarray(enc["input_ids"])
            out = apply(tensor(enc["input_ids"]), tensor(enc["attention_mask"]), None)
        logits = out.float().cpu().numpy()
        for r, text in enumerate(texts):
            fills = []
            for pos in np.flatnonzero(ids_np[r] == mask_id):
                top = np.argsort(-logits[r, pos])[: args.top_k or 5]
                fills.append({"position": int(pos),
                              "top_tokens": tokenizer.convert_ids_to_tokens(top),
                              "top_ids": top.tolist()})
            results.append({"text": text, "fills": fills})
    else:
        raise ValueError(f"unknown task {args.task!r}")
    return results


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--task", default="seq-cls",
                    choices=["seq-cls", "token-cls", "qa", "seq2seq", "causal-lm", "mlm", "rtd"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--text", default=None)
    ap.add_argument("--context", default=None)
    ap.add_argument("--input_file", default=None,
                    help="jsonl with {'text': ..., 'context'?: ...}")
    ap.add_argument("--num_labels", type=int, default=2)
    ap.add_argument("--adapter", default=None,
                    help="LoRA adapter dir (adapter.safetensors + "
                         "adapter_config.json) merged onto the base "
                         "checkpoint at load")
    ap.add_argument("--doc_stride", type=int, default=0,
                    help="QA: window long contexts with this token stride "
                         "instead of truncating (HF run_qa; 0 = off)")
    ap.add_argument("--prefill_chunk", type=int, default=0,
                    help="split long-prompt prefill into fixed-size "
                         "chunks (causal-lm; same tokens out)")
    ap.add_argument("--kv_cache", choices=["fp", "int8"], default="fp",
                    help="decode KV cache storage (GPT-2)")
    ap.add_argument("--draft_dir", default=None,
                    help="draft-model checkpoint dir for speculative "
                         "decoding (causal-lm, or seq2seq for the T5 "
                         "family; greedy-exact at temperature 0)")
    ap.add_argument("--speculate_k", type=int, default=4,
                    help="draft tokens per verify window (--draft_dir / "
                         "--self_speculate_layers)")
    ap.add_argument("--self_speculate_layers", type=int, default=0,
                    help="layer-skip self-speculation: draft = the "
                         "target's own first N layers (no draft "
                         "checkpoint; greedy-exact like --draft_dir)")
    ap.add_argument("--quantize", choices=["none", "int8"], default="none",
                    help="int8 weight-only dense kernels for causal-lm "
                         "and seq2seq generation")
    ap.add_argument("--max_seq_length", type=int, default=512)
    ap.add_argument("--max_new_tokens", type=int, default=64)
    ap.add_argument("--num_beams", type=int, default=1)
    ap.add_argument("--length_penalty", type=float, default=1.0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top_k", type=int, default=0)
    ap.add_argument("--top_p", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.text and not args.input_file:
        ap.error("provide --text or --input_file")
    for row in predict(args):
        print(json.dumps(row))


if __name__ == "__main__":
    main(sys.argv[1:])

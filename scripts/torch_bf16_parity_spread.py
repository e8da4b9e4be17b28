#!/usr/bin/env python3
"""How far a bf16 train step lands from the fp32 one, through the flash
kernels and through the plain attention, over several seeds: for each
encoder family (``chip_smoke.py``'s published configs at depth 2), seed
(weights and a batch of 8 x 512 reviews) and path, the distance from the
fp32 plain step of the loss and of the two-label classifier's bias
gradient (quantities with one degree of freedom), and of the whole
gradient. Prints one JSON line per family with the per-seed distances
and the share of seeds where the kernels' distance is the larger.

    python3 scripts/torch_bf16_parity_spread.py [--seeds 8]

Needs a CUDA card and ``nvcc`` (the flash kernels build at first use)."""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _step(family, hf, batch, impl, dtype, seed):
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
        init_encoder,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import (
        seq_cls_loss,
    )

    cfg = auto.CONFIG_BUILDERS[family](hf, hidden_dropout=0.0, attention_dropout=0.0,
                                       classifier_dropout=0.0, attention_impl=impl,
                                       dtype=dtype, num_layers=2)
    model = init_encoder(auto.build_model(family, "seq-cls", cfg), seed=seed,
                         device="cuda").train()
    loss, _ = seq_cls_loss(model, batch)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().float().clone()
                                  for n, p in model.named_parameters()}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, default=8)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as c

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    families = [("bert", c.BERT_BASE)] + c._parity_families()
    for family, hf in families:
        rows = []
        for seed in range(args.seeds):
            full = c._review_batch(8 * (seed + 1), 512, "cuda", vocab=hf["vocab_size"])
            batch = {k: v[-8:] for k, v in full.items()}
            l32, g32 = _step(family, hf, batch, "xla", torch.float32, seed)
            out = {}
            for impl in ("flash", "xla"):
                l16, g16 = _step(family, hf, batch, impl, torch.bfloat16, seed)
                bias = next(n for n, g in g32.items()
                            if n.endswith("classifier.bias") and g.numel() == 2)
                out[impl] = {"loss": abs(l16 - l32),
                             "head_bias": float((g16[bias] - g32[bias]).norm()),
                             "step": math.sqrt(sum(float((g16[n] - g32[n]).norm()) ** 2
                                                   for n in g32
                                                   if not n.endswith("key.bias")))}
            rows.append(out)
        summary = {k: sum(r["flash"][k] > r["xla"][k] for r in rows) / len(rows)
                   for k in ("loss", "head_bias", "step")}
        print(json.dumps({"family": family, "layers": 2, "seeds": args.seeds,
                          "card": torch.cuda.get_device_name(0),
                          "share_kernels_further": summary, "per_seed": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

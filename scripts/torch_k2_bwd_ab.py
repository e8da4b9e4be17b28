#!/usr/bin/env python3
"""Parent-against-change device time of the fused vocab-CE backward (K2's
dH and dW) or forward of the PyTorch port on one card.

    python3 scripts/torch_k2_bwd_ab.py PARENT_DIR CHANGE_DIR [--pairs 2] [--mode bwd|fwd]

Each directory holds an unpacked tree of this repository (``git archive``).
Each run is one process in one tree, over every bf16-hidden case of the
change's ``chip_smoke.VOCAB_CASES`` (seeded random inputs at the cases'
shapes): with ``--mode bwd`` (the default) the tree's backward for dH and
dW together, that is ``fused_ce_bwd`` where the tree has it, else
``fused_ce_bwd_dh`` then ``fused_ce_bwd_dw``; with ``--mode fwd`` the
tree's ``fused_ce_fwd``. Per case it prints the profiler's device time per
call (every device activity of the window over the calls, the tree's own
``chip_smoke._device_ms``: median of 3 windows of 5 calls) and the
CUDA-event time per call. Runs go in turns parent, change, change,
parent, ...; each prints one JSON line, and a last line gives each tree's
median per case and the change's time over the parent's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

RUN = """
import json, sys
import chip_smoke as c
sys.path.insert(0, str(c.ROOT))
import torch
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import vocab_ce as vc
torch.backends.cuda.matmul.allow_tf32 = False
vc.load_kernel()
out = {}
for case in json.loads(sys.argv[1]):
    name, N, V, H, dt, eps, ties = case
    gen = torch.Generator().manual_seed(2)
    sets = [c._vocab_inputs(case, gen, torch.device("cuda")) for _ in range(2)]
    if sys.argv[2] == "fwd":
        args = [(h, w, l) for h, w, l, g in sets]
        fn = lambda *a: vc.fused_ce_fwd(*a, eps)
    else:
        args = [(h, w, l, vc.fused_ce_fwd_reference(h, w, l, eps)[1], g) for h, w, l, g in sets]
        if hasattr(vc, "fused_ce_bwd"):
            fn = lambda *a: vc.fused_ce_bwd(*a, eps)
        else:
            fn = lambda *a: (vc.fused_ce_bwd_dh(*a, eps), vc.fused_ce_bwd_dw(*a, eps))
    out[name] = {"device_ms": c._device_ms(fn, args, None, iters=5, repeats=3),
                 "event_ms": c._cuda_ms(fn, args, iters=5)}
    del sets, args
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def run(tree: str, cases: list, mode: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN, json.dumps(cases), mode], cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--mode", choices=("bwd", "fwd"), default="bwd")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    sys.path.insert(0, args.change)
    import chip_smoke

    cases = [list(c) for c in chip_smoke.VOCAB_CASES if c[4] == "bfloat16"]
    seen = {"parent": [], "change": []}
    for i in range(args.pairs):
        for name in (("parent", "change") if i % 2 == 0 else ("change", "parent")):
            got = run(getattr(args, name), cases, args.mode)
            seen[name].append(got)
            print(json.dumps({"pair": i, "tree": name, "mode": args.mode, "card": card,
                              "cases": got}), flush=True)
    summary = {}
    for case in (c[0] for c in cases):
        med = {t: {k: statistics.median(r[case][k] for r in runs)
                   for k in ("device_ms", "event_ms")} for t, runs in seen.items()}
        summary[case] = {**med, "change_over_parent": med["change"]["device_ms"]
                         / med["parent"]["device_ms"]}
    print(json.dumps({"card": card, "mode": args.mode, "pairs": args.pairs, "median": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

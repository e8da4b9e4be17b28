#!/usr/bin/env python3
"""Parent-against-change training throughput of the PyTorch port on one card.

    python3 scripts/torch_train_ab.py PARENT_DIR CHANGE_DIR [--pairs 10]
        [--run bert|tinyllama|optim]

Each directory holds an unpacked tree of this repository (``git archive``).
Each run is one process in one tree: with ``--run bert`` (the default)
``chip_smoke.py``'s train-phase CLI run (BERT-base widths, random weights,
the CLI's defaults, 40 steps of the vendored reviews); with ``--run
tinyllama`` its ``tinyllama_train_phase`` (TinyLlama-1.1B widths at full
depth through the causal-LM CLI, 12 steps of 4 x 1024, then the profiled
steps' device busy time, idle share and K2's share of the busy time, and
the fp32 gate); with ``--run optim`` the data-parallel optimizer runs of
its ``optim_memory_phase`` (AdamW with fp32 and with bf16 moments, and
LAMB, no remat) on BERT-large-WWM seq-cls at all 24 layers, each one's
step time (the reported samples/s are AdamW fp32's). Runs go in turns
parent, change, change, parent, ...; each prints one JSON line, and a last
line gives each tree's median and quartiles of train samples/s per GPU
(and of each ``*_step_ms``), and how many pairs the change won.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

RUN = """
import json, sys, tempfile
from pathlib import Path
import chip_smoke as c
sys.path.insert(0, str(c.ROOT))
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli
w = Path(tempfile.mkdtemp())
res, trainer = cli.run(c._train_argv(w, w / "out", w / "model"))
print(json.dumps({"samples_per_s": res["train"]["train_samples_per_second_per_chip"],
                  "step_time_s": trainer.meter.avg_step_time}))
"""

RUN_TINYLLAMA = """
import contextlib, io, json, sys, tempfile
from pathlib import Path
import chip_smoke as c
sys.path.insert(0, str(c.ROOT))
with contextlib.redirect_stdout(io.StringIO()):
    card = c.env_phase()
    row = c.tinyllama_train_phase(Path(tempfile.mkdtemp()), card)["tinyllama"]
print(json.dumps({"samples_per_s": row["train_samples_per_second_per_chip"],
                  "step_time_s": row["step_time_ms"] / 1e3,
                  **{k: row.get(k) for k in ("device_busy_ms_per_step", "idle_share",
                                             "k2_ms_per_step", "k2_share_of_busy",
                                             "train_mfu")}}))
"""

RUN_OPTIM = """
import contextlib, io, json, sys
import chip_smoke as c
sys.path.insert(0, str(c.ROOT))
c._no_tf32()
if hasattr(c, "OPTIM_DEPTH"):
    c.OPTIM_DEPTH = c.BERT_LARGE["num_hidden_layers"]
out = {}
with contextlib.redirect_stdout(io.StringIO()):
    state = c._bert_large_state()
    batch = c._review_batch(8, 512, c.DEVICE, vocab=c.BERT_LARGE["vocab_size"])
    for name, over, policy in c.OPTIM_RUNS[:3]:
        out[name + "_step_ms"] = c._optim_run(name, over, policy, state, batch)["step_ms"]
out["samples_per_s"] = 8e3 / out["adamw_fp32_step_ms"]
print(json.dumps(out))
"""
CODE = {"bert": RUN, "tinyllama": RUN_TINYLLAMA, "optim": RUN_OPTIM}
# one run's limit: a hung run fails the comparison instead of the call
RUN_TIMEOUT_S = 600


def run(tree: str, code: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                          text=True, timeout=RUN_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--run", choices=tuple(CODE), default="bert")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=30).stdout.strip()
    seen = {"parent": [], "change": []}
    pairs = []
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        got = {}
        for name in order:
            out = run(getattr(args, name), CODE[args.run])
            got[name] = out["samples_per_s"]
            seen[name].append(out)
            print(json.dumps({"pair": i, "tree": name, "card": card, **out}), flush=True)
        pairs.append(got)
    summary = {"card": card, "run": args.run, "pairs": args.pairs,
               "change_won": sum(p["change"] > p["parent"] for p in pairs)}
    for name, outs in seen.items():
        summary[name] = {}
        for key in [k for k in outs[0] if k == "samples_per_s" or k.endswith("_step_ms")]:
            xs = [o[key] for o in outs]
            q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
            summary[name][key] = {"median": statistics.median(xs), "quartiles": [q[0], q[2]],
                                  "range": [min(xs), max(xs)]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

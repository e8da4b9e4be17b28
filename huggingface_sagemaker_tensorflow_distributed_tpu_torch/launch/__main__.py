"""Submit a fine-tuning job (the port's counterpart of the reference's
``launch.py`` and the JAX package's root ``launch.py``): the same flags,
defaults and pass-through of extra ``--key value`` pairs, with the port's
training CLI as the entry point.

    # one GPU of this machine (the default slice)
    python -m huggingface_sagemaker_tensorflow_distributed_tpu_torch.launch \\
        --model_name_or_path DIR --dataset vendored_reviews --from_scratch true

    # the CPU simulator: 2 hosts on the CPU over gloo
    python -m huggingface_sagemaker_tensorflow_distributed_tpu_torch.launch \\
        --slice cpu-2 --num_hosts 2 --model_name_or_path DIR ...

    # print one ssh + torchrun command per node of a 2 x 8 H100 slice
    python -m huggingface_sagemaker_tensorflow_distributed_tpu_torch.launch \\
        --slice h100-16 --nodes node-a,node-b
"""

from __future__ import annotations

import argparse
import sys

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.launch.launcher import (
    TRAIN_ENTRY,
    GPUJob,
    NodeBackend,
    _default_job_root,
)


def hyperparameters(ns: argparse.Namespace, extra: list) -> dict:
    """The reference's hyperparameters (``launch.py:13-18``) and the extra
    ``--key value`` pairs; a bare ``--flag`` (followed by another option)
    is ``true``."""
    hp = {"epochs": ns.epochs, "train_batch_size": ns.train_batch_size,
          "eval_batch_size": ns.eval_batch_size,
          "model_name_or_path": ns.model_name_or_path, "learning_rate": ns.learning_rate}
    i = 0
    while i < len(extra):
        tok = extra[i]
        if tok.startswith("--"):
            if i + 1 < len(extra) and not extra[i + 1].startswith("--"):
                hp[tok[2:]] = extra[i + 1]
                i += 2
                continue
            hp[tok[2:]] = "true"
        i += 1
    return hp


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(allow_abbrev=False)
    parser.add_argument("--slice", default="h100-1",
                        help="h100-N / h200-N (8 GPUs a node) or cpu-N for the CPU simulator")
    parser.add_argument("--num_hosts", type=int, default=None,
                        help="simulated host count (local backend)")
    parser.add_argument("--entry_point", default=TRAIN_ENTRY)
    parser.add_argument("--base_job_name", default="huggingface-gpu")
    parser.add_argument("--job_root", default=_default_job_root())
    parser.add_argument("--nodes", default=None,
                        help="comma-separated node names of a multi-node slice")
    parser.add_argument("--execute", action="store_true",
                        help="run the node commands (default: print them)")
    parser.add_argument("--timeout", type=float, default=None,
                        help="seconds after which every process of the job is ended")
    # hyperparameters (reference launch.py:13-18 defaults)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--train_batch_size", type=int, default=8)
    parser.add_argument("--eval_batch_size", type=int, default=4)
    parser.add_argument("--model_name_or_path",
                        default="bert-large-uncased-whole-word-masking")
    parser.add_argument("--learning_rate", type=float, default=5e-5)
    ns, extra = parser.parse_known_args(argv)

    job = GPUJob(entry_point=ns.entry_point, slice_spec=ns.slice, num_hosts=ns.num_hosts,
                 hyperparameters=hyperparameters(ns, extra),
                 base_job_name=ns.base_job_name, job_root=ns.job_root)
    backend = None
    if ns.nodes or ns.execute:
        backend = NodeBackend(nodes=ns.nodes.split(",") if ns.nodes else None,
                              execute=ns.execute)
    handle = job.fit(wait=False, backend=backend)
    handle.wait(timeout=ns.timeout)
    if handle.procs:
        print(f"job {handle.job_name} done; artifacts in {handle.job_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

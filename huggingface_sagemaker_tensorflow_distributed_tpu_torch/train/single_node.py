"""Single-node training entry (counterpart of the JAX package's
``scripts/single_node_train.py``): the training CLI with the learning rate
not scaled by the world size, as the reference's single-node script
compiles a plain ``Adam(lr)``, unless the caller passes
``--scale_lr_by_world_size`` itself.

    python -m huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.single_node ARGS
"""

from __future__ import annotations

import sys

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--scale_lr_by_world_size" not in " ".join(argv):
        argv += ["--scale_lr_by_world_size", "false"]
    return cli.main(argv)


if __name__ == "__main__":
    cli.script(sys.argv[1:], main)

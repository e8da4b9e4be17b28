"""Job launch (counterpart of the JAX package's ``launch/``): a job's
hyperparameters become training processes on this machine's GPUs, on the
CPU simulator (``cpu-N``), or as one ``torchrun`` per node
(``python -m huggingface_sagemaker_tensorflow_distributed_tpu_torch.launch``
is the reference's ``launch.py``)."""

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.launch.launcher import (  # noqa: F401
    GPUJob,
    JobHandle,
    LocalBackend,
    NodeBackend,
    make_job_name,
    to_argv,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.launch.slice import (  # noqa: F401
    SliceConfig,
)

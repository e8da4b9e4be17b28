"""Result-file emission, the ``key = value`` contract (counterpart of the
JAX package's ``utils/results.py``): one line per metric in
``output_data_dir``, written by rank 0 of ``torch.distributed`` only."""

from __future__ import annotations

import os
from typing import Any, Mapping

import torch.distributed as dist


def process_index() -> int:
    """This process's rank (0 without an initialized process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def write_results_file(output_data_dir: str, filename: str,
                       results: Mapping[str, Any], logger=None,
                       host0_only: bool = True) -> str | None:
    """Write ``key = value`` lines to ``output_data_dir/filename``.
    Returns the path written, or None when skipped on a non-zero rank."""
    if host0_only and process_index() != 0:
        return None
    os.makedirs(output_data_dir, exist_ok=True)
    path = os.path.join(output_data_dir, filename)
    with open(path, "w") as writer:
        for key, value in results.items():
            if logger is not None:
                logger.info("  %s = %s", key, value)
            writer.write("%s = %s\n" % (key, value))
    return path


def read_results_file(path: str) -> dict[str, str]:
    """Parse a ``key = value`` results file back into a dict."""
    out: dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or " = " not in line:
                continue
            key, value = line.split(" = ", 1)
            out[key] = value
    return out

"""GPU node topology (counterpart of the JAX package's ``launch/slice.py``).

The reference names a machine by its instance type and count
(``instance_type``/``instance_count``, reference ``launch.py:27-29,42,45``);
the JAX package names a TPU slice. A job of the port names its GPUs:
``h100-16`` is 16 H100s, eight to a node, so two nodes; a slice of fewer
than eight GPUs is one node with that many. ``cpu-N`` is the local
simulator: processes on this machine, on the CPU, over gloo (the number of
simulated hosts is the job's ``num_hosts``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

# accelerator -> GPUs per node (an HGX/DGX board of eight)
_GPUS_PER_NODE = {
    "h100": 8,
    "h200": 8,
}


@dataclass(frozen=True)
class SliceConfig:
    """A set of GPUs, e.g. ``h100-16`` = 2 nodes x 8 GPUs."""

    accelerator: str       # h100 | h200 | cpu (local simulator)
    num_chips: int

    @classmethod
    def parse(cls, spec: str) -> "SliceConfig":
        """Parse ``"h100-16"`` / ``"h200-8"`` / ``"cpu-2"`` names."""
        m = re.fullmatch(r"([a-z][a-z0-9]*)-(\d+)", spec.strip().lower())
        if not m or int(m.group(2)) < 1:
            raise ValueError(
                f"bad slice spec {spec!r}; expected e.g. 'h100-16' or 'cpu-2'")
        return cls(accelerator=m.group(1), num_chips=int(m.group(2)))

    @property
    def chips_per_host(self) -> int:
        """GPUs on each node (a slice below one full node: all of them)."""
        if self.accelerator == "cpu":
            return self.num_chips  # simulator: the job's num_hosts picks the processes
        per = _GPUS_PER_NODE.get(self.accelerator)
        if per is None:
            raise ValueError(f"unknown accelerator {self.accelerator!r} "
                             f"(known: {sorted(_GPUS_PER_NODE)} + cpu)")
        if self.num_chips > per and self.num_chips % per:
            raise ValueError(f"{self.name}: a slice of more than one node must fill "
                             f"its nodes ({per} GPUs each)")
        return min(per, self.num_chips)

    @property
    def num_hosts(self) -> int:
        if self.accelerator == "cpu":
            return 1
        return self.num_chips // self.chips_per_host

    @property
    def name(self) -> str:
        return f"{self.accelerator}-{self.num_chips}"

"""The card topology the resource scheduler carves into resources (the
port's counterpart of ``llmq_tpu/scheduling/topology.py``).

:class:`GpuTopology` has the data shape of the JAX package's
``TpuTopology`` (chips grouped by host, ``total_hbm_gb``, ``to_dict``);
a chip here is one CUDA device. :meth:`GpuTopology.discover` reads the
cards through ``torch.cuda``; an explicit ``"cpu"`` device is one host
"chip" with a nominal 16 GB, as the JAX package's CPU devices are, so
the scheduler can be driven in tests. On ``cuda`` without a card it
raises: nothing falls back to the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional

log = logging.getLogger("llmq_tpu_torch.topology")

#: Memory of the host "chip" of an explicit CPU device (GB), the JAX
#: package's default for an unknown device kind.
CPU_CHIP_GB = 16.0


@dataclass
class ChipInfo:
    id: int
    kind: str = "unknown"           # e.g. "NVIDIA H100 80GB HBM3"
    process_index: int = 0          # host this chip belongs to
    coords: Optional[tuple] = None  # interconnect coordinates if known
    hbm_gb: float = CPU_CHIP_GB
    #: The chip's platform: "cuda" or "cpu" (the capability tag its
    #: resource carries).
    platform: str = "cuda"

    def to_dict(self) -> Dict:
        return {
            "id": self.id,
            "kind": self.kind,
            "process_index": self.process_index,
            "coords": self.coords,
            "hbm_gb": self.hbm_gb,
        }


@dataclass
class GpuTopology:
    """The cards of one host (``num_hosts`` > 1 only when declared)."""

    chips: List[ChipInfo] = field(default_factory=list)
    num_hosts: int = 1
    slice_name: str = "slice0"

    @property
    def num_chips(self) -> int:
        return len(self.chips)

    @property
    def total_hbm_gb(self) -> float:
        return sum(c.hbm_gb for c in self.chips)

    def to_dict(self) -> Dict:
        return {
            "slice_name": self.slice_name,
            "num_chips": self.num_chips,
            "num_hosts": self.num_hosts,
            "total_hbm_gb": self.total_hbm_gb,
            "chips": [c.to_dict() for c in self.chips],
        }

    @classmethod
    def declare(cls, num_chips: int, num_hosts: int = 1,
                kind: str = "NVIDIA H100 80GB HBM3", hbm_gb: float = 80.0,
                slice_name: str = "slice0") -> "GpuTopology":
        """A topology without hardware (control plane, tests)."""
        per_host = max(1, num_chips // max(1, num_hosts))
        chips = [ChipInfo(id=i, kind=kind, process_index=i // per_host,
                          hbm_gb=hbm_gb) for i in range(num_chips)]
        return cls(chips=chips, num_hosts=num_hosts, slice_name=slice_name)

    @classmethod
    def discover(cls, device: str = "cuda") -> "GpuTopology":
        """The live devices: every visible CUDA card (its name, and its
        ``total_memory`` in GB of 2**30 bytes, as the card's name counts
        them) for a ``cuda`` device, one host chip for an explicit
        ``cpu``."""
        import torch

        from llmq_tpu_torch.core.config import resolve_device

        dev = resolve_device(device)
        if dev.type == "cpu":
            chips = [ChipInfo(id=0, kind="cpu", hbm_gb=CPU_CHIP_GB,
                              platform="cpu")]
        else:
            chips = []
            for i in range(torch.cuda.device_count()):
                props = torch.cuda.get_device_properties(i)
                chips.append(ChipInfo(id=i, kind=props.name,
                                      hbm_gb=props.total_memory / 2**30,
                                      platform="cuda"))
            if not chips:
                raise RuntimeError("CUDA reports no device")
        topo = cls(chips=chips)
        log.info("discovered topology: %d chip(s) on 1 host, kind=%s",
                 topo.num_chips, chips[0].kind)
        return topo

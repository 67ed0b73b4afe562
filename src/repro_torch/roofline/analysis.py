"""Roofline terms of a dry-run step (counterpart of `repro.roofline.analysis`).

compute term    = flops_per_device / peak_FLOP/s
memory term     = bytes_per_device / HBM_bw
collective term = collective_bytes_per_device / link_bw

The per-device figures are `repro_torch.roofline.op_cost`'s count of one
traced step on one rank of the mesh (the local ops a rank runs, its local
collectives, and each kernel's own cost), where the reference parses the
partitioned HLO.  The constants are an H100 SXM5's
(`repro_torch.launch.mesh`).  The largest term is the bottleneck.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from repro_torch.roofline.op_cost import Cost


@dataclasses.dataclass
class RooflineReport:
    """One step's three roofline terms on one device, and its useful-FLOPs ratio.

    ``xla_cost_flops`` stays None: the reference reports XLA's own
    ``cost_analysis()`` beside its HLO count as a cross-reference, and an
    eager torch step has no compiler estimate to put there.
    """

    arch: str
    shape: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: Dict[str, float]
    model_flops_global: float  # 6 * N_active * tokens (x3 for fwd+bwd)
    xla_cost_flops: Optional[float] = None
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    ici_bw: float = LINK_BW  # the reference's name for the collective link rate

    @property
    def compute_term(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def memory_term(self) -> float:
        return self.bytes_per_device / self.hbm_bw

    @property
    def collective_term(self) -> float:
        return sum(self.collective_bytes_per_device.values()) / self.ici_bw

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_term,
            "memory": self.memory_term,
            "collective": self.collective_term,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: the remat / attention / capacity waste detector."""
        return self.model_flops_global / max(self.flops_per_device * self.chips, 1.0)

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "chips": self.chips,
            "compute_s": self.compute_term,
            "memory_s": self.memory_term,
            "collective_s": self.collective_term,
            "dominant": self.dominant,
            "model_flops": self.model_flops_global,
            "hlo_flops_global": self.flops_per_device * self.chips,
            "hlo_bytes_global": self.bytes_per_device * self.chips,
            "useful_ratio": self.useful_flops_ratio,
            "collectives_per_device": dict(self.collective_bytes_per_device),
            "xla_cost_flops_per_device": self.xla_cost_flops,
        }


def roofline_terms(arch: str, shape: str, chips: int, cost: Cost,
                   model_flops_global: float) -> RooflineReport:
    """The report of one device's counted ``cost`` of a step."""
    return RooflineReport(
        arch=arch,
        shape=shape,
        chips=chips,
        flops_per_device=cost.flops,
        bytes_per_device=cost.bytes,
        collective_bytes_per_device=dict(cost.collectives),
        model_flops_global=model_flops_global,
    )

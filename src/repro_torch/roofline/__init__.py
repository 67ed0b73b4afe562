"""Cost counting of eager PyTorch programs (port of `repro.roofline.hlo_cost`).

`op_cost.OpCost` counts the flops, bytes and collective bytes of the aten
ops dispatched inside it; the kernel wrappers add their own through
`op_cost.custom_op`.  `analysis.roofline_terms` turns one device's count
of a dry-run step into the three roofline terms at an H100's rates.
"""
from repro_torch.roofline.op_cost import Cost, OpCost, custom_op, module_cost

__all__ = ["Cost", "OpCost", "custom_op", "module_cost"]

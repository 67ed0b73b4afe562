"""Cost counting of eager PyTorch programs (port of `repro.roofline.hlo_cost`).

`op_cost.OpCost` counts the flops, bytes and collective bytes of the aten
ops dispatched inside it; the kernel wrappers add their own through
`op_cost.custom_op`.  The reference's `roofline.analysis` (TPU mesh
constants) is not ported.
"""
from repro_torch.roofline.op_cost import Cost, OpCost, custom_op, module_cost

__all__ = ["Cost", "OpCost", "custom_op", "module_cost"]

"""The production mesh of H100s over a fake world (counterpart of
`repro.launch.mesh`).

`make_production_mesh` builds a `DeviceMesh` on device type ``"cpu"`` over
a fake process group of `num_chips` ranks (torch's ``"fake"`` backend and
its `FakeStore`: collectives return without moving data), so a dry run
traces a step on 256 or 512 ranks from one process on any machine, with
no card: it never calls ``torch.cuda`` (a ``"cuda"`` mesh would, and
raises in a CPU build).  A process group can be initialised once a
process: `make_production_mesh` tears down a world it built before
building one of another size, so one process can sweep both meshes.

The shapes are the reference's, (16, 16) and (2, 16, 16), so the bytes
each device holds can be held against it exactly.  The constants are the
datasheet's for the card the port runs on, an H100 SXM5 80GB HBM3 at
700 W; they feed `repro_torch.roofline.analysis`.
"""
from __future__ import annotations

# H100 SXM5 datasheet constants (per card), for the roofline analysis.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12              # bytes/s, HBM3
# One card's NIC: a 400 Gb/s InfiniBand link.  It stands where the
# reference's per-chip ICI_BW stands: an axis 16 cards wide spans two
# 8-card NVLink nodes, so its collectives cross this link.
LINK_BW = 50e9                # bytes/s

SINGLE_POD_SHAPE = (16, 16)           # 256 cards
MULTI_POD_SHAPE = (2, 16, 16)         # 2 pods x 256 cards


def num_chips(mesh) -> int:
    """The cards (ranks) of ``mesh``."""
    n = 1
    for s in mesh.shape:
        n *= s
    return n


def init_fake_world(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks, this process rank 0.

    A world of another size is destroyed first; one of the same size is kept.
    DTensor's caches go with a destroyed world: they key meshes by shape and
    axis names, not by process group, so a mesh of the new world equal to one
    of the old would be handed the old one's groups, which no longer resolve.
    """
    import torch.distributed as dist
    from torch.distributed.tensor._redistribute import _gen_transform_infos
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
        _clear_sharding_prop_cache()
        _gen_transform_infos.cache_clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) ``("pod", "data",
    "model")``, on a fake world of as many ranks."""
    shape = MULTI_POD_SHAPE if multi_pod else SINGLE_POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape, axes):
    """A ``"cpu"`` `DeviceMesh` of ``shape`` named ``axes`` over a fake world of its size."""
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    init_fake_world(n)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))

"""Logical-axis sharding over a `DeviceMesh` (counterpart of
`repro.distributed.sharding`).

Model code names the axes of every parameter and key activation
("vocab", "heads", "ffn", "expert", "batch", ...).  A rule table maps each
logical name to mesh axes; `logical_to_spec` turns a tuple of logical
names into a spec, one entry a tensor dim (None, a mesh axis name, or a
tuple of them, as a ``PartitionSpec`` holds them), and `placements` turns
a spec into DTensor placements, one a mesh dim.  Changing a sharding
strategy means swapping the rule table, not touching model code.

`enter_mesh` installs an ambient mesh; `with_logical_constraint`
redistributes a DTensor to its logical axes' placements under that mesh
and returns its argument untouched outside one, so every single-card path
runs as it did.  `AbstractMesh` is a mesh of names and sizes with no
devices and no process group, which is all `logical_to_spec` reads.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

# Baseline rule table: tensor parallelism over "model", batch data-parallel
# over ("pod", "data") when a pod axis exists.
DEFAULT_RULES: Dict[str, object] = {
    "batch": ("pod", "data"),  # activations' batch dim
    "actors": ("pod", "data"),  # async runner's actor-replica lane axis
    "seq": None,
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "kv_seq": "model",  # flash-decoding cache sharding (opt-in via cache axes)
    "head_dim": None,
    "embed": None,
    "ffn": "model",
    "expert": "model",
    "expert_ffn": None,
    "dinner": "model",
    "state": None,
    "layers": None,
    "codebooks": None,
}

# FSDP+TP: additionally shard the d_model ("embed") dim of weights over the
# data axis, which 405B/1T-class params need to fit a device.  For
# activations the "embed" rule is inert because the batch dim claims the
# data axis first (logical_to_spec never reuses a mesh axis within a spec).
FSDP_TP_RULES: Dict[str, object] = dict(DEFAULT_RULES, embed="data")

# + sequence parallelism: residual activations between layers are sharded on
# the sequence dim over "model" (attention/FFN internals gather as needed).
FSDP_TP_SP_RULES: Dict[str, object] = dict(FSDP_TP_RULES, seq="model")

PROFILES: Dict[str, Dict[str, object]] = {
    "tp": DEFAULT_RULES,
    "fsdp_tp": FSDP_TP_RULES,
    "fsdp_tp_sp": FSDP_TP_SP_RULES,
}

Spec = Tuple[object, ...]  # one entry a tensor dim: None, an axis name, or a tuple of names


def rules_for(profile: str) -> Dict[str, object]:
    """The rule table registered under ``profile`` (see `PROFILES`)."""
    return PROFILES[profile]


# Ambient rule table that with_logical_constraint reads inside model code;
# the dry run installs the config's profile with set_active_rules.
_ACTIVE_RULES: list = [DEFAULT_RULES]
_MESHES: list = []  # the ambient meshes installed by enter_mesh, innermost last


class set_active_rules:
    """Context manager installing a rule table (by dict or profile name)
    as the ambient rules `with_logical_constraint` reads by default."""

    def __init__(self, rules):
        self.rules = rules if isinstance(rules, dict) else rules_for(rules)

    def __enter__(self):
        _ACTIVE_RULES.append(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _ACTIVE_RULES.pop()
        return False


def active_rules() -> Dict[str, object]:
    """The innermost rule table installed by `set_active_rules`."""
    return _ACTIVE_RULES[-1]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Mesh axis names and sizes with no devices: what `logical_to_spec` reads."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a `DeviceMesh` or an `AbstractMesh`, in mesh order."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def logical_to_spec(
    logical_axes: Optional[Sequence[Optional[str]]],
    rules: Dict[str, object],
    mesh,
    shape: Optional[Sequence[int]] = None,
) -> Spec:
    """Convert a tuple of logical axis names to a spec valid on ``mesh``.

    If ``shape`` is given, mesh axes whose size does not divide the
    corresponding dimension are dropped, as the reference drops them (JAX
    rejects uneven shardings; DTensor would take them, but the two must
    agree): e.g. 8 kv heads on a 16-way "model" axis fall back to
    replicated.  A mesh axis is never used twice within one spec.
    Trailing None entries are trimmed, as ``PartitionSpec`` prints them.
    """
    if logical_axes is None:
        return ()
    sizes = mesh_axes(mesh)
    used = set()
    entries = []
    for i, name in enumerate(logical_axes):
        target = None if name is None else rules.get(name, None)
        if target is None:
            entries.append(None)
            continue
        if isinstance(target, str):
            target = (target,)
        # keep only axes present in this mesh and not already used in this spec
        phys = tuple(a for a in target if a in sizes and a not in used)
        if shape is not None and phys:
            kept, prod = [], 1
            for a in phys:
                if shape[i] % (prod * sizes[a]) == 0:
                    kept.append(a)
                    prod *= sizes[a]
            phys = tuple(kept)
        used.update(phys)
        if not phys:
            entries.append(None)
        elif len(phys) == 1:
            entries.append(phys[0])
        else:
            entries.append(phys)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec``, one a mesh dim: ``Shard(i)`` where
    tensor dim i names the mesh dim, else ``Replicate()``.

    A dim sharded over several mesh axes (``("pod", "data")``) is split
    major-first in mesh order, as a ``PartitionSpec`` tuple is.
    """
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for i, entry in enumerate(spec):
        for a in (entry,) if isinstance(entry, str) else (entry or ()):
            where[a] = i
    return tuple(Shard(where[a]) if a in where else Replicate() for a in mesh_axes(mesh))


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """A device's shard of a tensor of ``shape`` laid out by ``spec`` (divisible dims)."""
    sizes = mesh_axes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        for a in (entry,) if isinstance(entry, str) else (entry or ()):
            out[i] //= sizes[a]
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the port's ``jax.sharding.NamedSharding``."""

    mesh: object
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _is_axes_leaf(x) -> bool:
    return x is None or isinstance(x, tuple)


def _map_axes(fn, axes_tree, *trees):
    """``fn`` over the leaves of ``axes_tree`` (tuples or None) and the matching
    leaves of ``trees`` (dicts and lists, as `repro_torch.tree` walks them)."""
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v, *(t[k] for t in trees)) for k, v in axes_tree.items()}
    return [_map_axes(fn, v, *(t[i] for t in trees)) for i, v in enumerate(axes_tree)]


def tree_shardings(axes_tree, mesh, rules: Optional[Dict[str, object]] = None, shapes_tree=None):
    """Map a tree of logical-axis tuples to a tree of `NamedSharding`.

    Leaves of ``axes_tree`` are tuples (possibly empty) of logical names or
    None entries; a None leaf is replicated.  With ``shapes_tree`` (a
    matching tree of tensors, or of anything with a ``shape``),
    non-dividing mesh axes are dropped leaf by leaf.
    """
    rules = DEFAULT_RULES if rules is None else rules
    if shapes_tree is None:
        return _map_axes(lambda ax: NamedSharding(mesh, logical_to_spec(ax, rules, mesh)),
                         axes_tree)
    return _map_axes(
        lambda ax, arr: NamedSharding(mesh, logical_to_spec(ax, rules, mesh, shape=arr.shape)),
        axes_tree, shapes_tree)


@contextlib.contextmanager
def enter_mesh(mesh):
    """Install ``mesh`` (a `DeviceMesh`) as the ambient mesh within the block.

    Inside, a plain tensor meeting a DTensor in an op counts as replicated
    (`implicit_replication`): positions, masks and scalars made by model
    code need no placements of their own.
    """
    from torch.distributed.tensor.experimental import implicit_replication

    _MESHES.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _MESHES.pop()


def ambient_mesh():
    """The mesh installed by `enter_mesh`, or None outside any."""
    return _MESHES[-1] if _MESHES else None


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor off a mesh)."""
    if not _MESHES:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def with_logical_constraint(x, logical_axes, rules=None, shape=None):
    """Lay ``x`` out by its logical axes under the ambient mesh.

    Under `enter_mesh`, a DTensor is redistributed to the placements of
    ``logical_to_spec(logical_axes, rules, mesh, shape)`` (a pending
    partial sum is reduced, a gathered dim sliced, a sharded one
    gathered); outside any mesh, and for a plain tensor, ``x`` itself is
    returned.  ``rules`` defaults to `active_rules`, ``shape`` (the sizes
    that mesh axes must divide) to ``x.shape``.
    """
    mesh = ambient_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    rules = active_rules() if rules is None else rules
    shape = x.shape if shape is None else shape
    want = placements(logical_to_spec(logical_axes, rules, mesh, shape=shape), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def sharded_zeros(shape, logical_axes, *, dtype, device):
    """``torch.zeros``; under `enter_mesh`, a DTensor of zeros laid out by
    ``logical_axes`` under the active rules, each rank allocating its shard."""
    mesh = ambient_mesh()
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import zeros

    spec = logical_to_spec(logical_axes, active_rules(), mesh, shape=shape)
    return zeros(*shape, dtype=dtype, device_mesh=mesh, placements=placements(spec, mesh))


def layer_slice(x, i: int):
    """``x[i]`` along an unsharded leading (layer) dim; on a DTensor each rank
    takes the slice of its shard, a view (DTensor's own indexing gathers)."""
    if not is_dtensor(x):
        return x[i]
    from torch.distributed.tensor import Shard

    place = tuple(x.placements)
    if any(isinstance(p, Shard) and p.dim == 0 for p in place):
        raise ValueError("layer_slice needs the leading dim unsharded")
    out = [Shard(p.dim - 1) if isinstance(p, Shard) else p for p in place]
    return local_call(lambda t: t[i], x.device_mesh, out, (place,), x)


def assign(dst, src):
    """``dst.copy_(src)``, for a DTensor ``dst`` on its own shards (``src``
    laid out as ``dst`` first), so the write lands in ``dst``'s storage."""
    if not is_dtensor(dst):
        return dst.copy_(src)
    place = tuple(dst.placements)

    def write(d, s):
        d.copy_(s)
        return d

    return local_call(write, dst.device_mesh, list(place), (place, place), dst, src)


def regroup(rows, groups: int):
    """A (tokens, d) DTensor laid out so its rows split into ``groups`` whole
    groups a rank: its batch shards kept where they divide ``groups``, else
    gathered (a decode step's 128 tokens are one MoE group).  Off a mesh,
    ``rows`` itself."""
    if not is_dtensor(rows):
        return rows
    spec = logical_to_spec(("batch",), active_rules(), rows.device_mesh, shape=(groups,))
    want = placements(spec, rows.device_mesh)
    if tuple(rows.placements) == want:
        return rows
    return rows.redistribute(rows.device_mesh, want)


def shard_index(mesh, axes) -> Tuple[int, int]:
    """(this rank's index, the shard count) of a dim split over mesh ``axes``,
    major-first in mesh order, as `placements` splits it."""
    index, shards = 0, 1
    for a in axes:
        size = mesh.size(mesh.mesh_dim_names.index(a))
        index, shards = index * size + mesh.get_local_rank(a), shards * size
    return index, shards


def sharded_dims(x) -> Dict[str, int]:
    """``{mesh axis: tensor dim}`` of the axes a DTensor is sharded over."""
    from torch.distributed.tensor import Shard

    names = x.device_mesh.mesh_dim_names
    return {names[i]: p.dim for i, p in enumerate(x.placements) if isinstance(p, Shard)}


def sharded_embed(table, ids):
    """``F.embedding(ids, table)`` for a DTensor ``table`` (V, d) and ``ids``.

    The vocab-parallel lookup: the table keeps its vocab shards (its
    ``embed`` shards are gathered, the FSDP all-gather), each rank looks up
    the ids that fall in its rows and zeroes the rest, and the rows come
    back as a partial sum over the vocab's mesh axes, which the caller's
    `with_logical_constraint` reduces.  ``ids`` keep their batch shards.
    """
    import torch.nn.functional as F
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    vocab_axes = [a for a, d in sharded_dims(table).items() if d == 0]
    id_dims = sharded_dims(ids) if is_dtensor(ids) else {}
    t_place = tuple(Shard(0) if a in vocab_axes else Replicate() for a in names)
    i_place = tuple(Shard(id_dims[a]) if a in id_dims and a not in vocab_axes else Replicate()
                    for a in names)
    o_place = tuple(Partial() if a in vocab_axes else i_place[k] for k, a in enumerate(names))
    rows = table.shape[0]

    def lookup(t, i):
        index, shards = shard_index(mesh, vocab_axes)
        lo = index * (rows // shards)
        inside = (i >= lo) & (i < lo + t.shape[0])
        out = F.embedding(torch.where(inside, i - lo, 0), t)
        return out * inside[..., None].to(out.dtype)

    return local_call(lookup, mesh, list(o_place), (t_place, i_place), table, ids)


def sharded_take(values, index):
    """``values[..., index[...]]`` (the last dim picked by ``index``) for a DTensor
    ``values`` whose last dim may be sharded: each rank picks the indices in its
    slice and zeroes the rest, a partial sum over those axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = values.device_mesh
    names = mesh.mesh_dim_names
    last = values.dim() - 1
    vd = sharded_dims(values)
    cut = [a for a in names if vd.get(a) == last]
    v_place = tuple(Shard(vd[a]) if a in vd else Replicate() for a in names)
    i_place = tuple(Shard(vd[a]) if a in vd and a not in cut else Replicate() for a in names)
    o_place = [Partial() if a in cut else i_place[k] for k, a in enumerate(names)]
    n_all = values.shape[-1]

    def pick(v, i):
        index, shards = shard_index(mesh, cut)
        lo = index * (n_all // shards)
        inside = (i >= lo) & (i < lo + v.shape[-1])
        got = torch.gather(v, -1, torch.where(inside, i - lo, 0)[..., None].long())[..., 0]
        return got * inside.to(got.dtype)

    return local_call(pick, mesh, o_place, (v_place, i_place), values, index)


def argmax(x):
    """``torch.argmax(x, dim=-1)``; on a DTensor whose last dim is sharded, each
    rank's best in its slice, then two all-reduces: the max value, and the
    least index holding it (ties go to the first index, as torch's do)."""
    if not is_dtensor(x):
        return torch.argmax(x, dim=-1)
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    last = x.dim() - 1
    xd = sharded_dims(x)
    cut = [a for a in names if xd.get(a) == last]
    x_place = tuple(Shard(xd[a]) if a in xd else Replicate() for a in names)
    o_place = [Replicate() if a in cut else x_place[k] for k, a in enumerate(names)]
    n_all = x.shape[-1]
    groups = [mesh.get_group(a) for a in cut]

    def best(v):
        index, shards = shard_index(mesh, cut)
        lo = index * (n_all // shards)
        top, idx = v.max(dim=-1)
        top = top.float()
        mine = top.clone()
        for g in groups:
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=g)
        idx = torch.where(mine == top, idx + lo, torch.full_like(idx, n_all))
        for g in groups:
            dist.all_reduce(idx, op=dist.ReduceOp.MIN, group=g)
        return idx

    return local_call(best, mesh, o_place, (x_place,), x)


def local_call(fn, mesh, out_placements, in_placements, *args, grad_placements=None):
    """``fn`` on the local shards of ``args``, laid out by ``in_placements``
    first (a DTensor is redistributed; None: a non-tensor argument), its
    outputs wrapped as DTensors with ``out_placements`` (a list for one
    output, a tuple of them for several): `local_map`, differentiable.

    ``grad_placements`` (default: `replicated_grads`) says how each
    input's local gradient lies: an input replicated over a mesh axis
    that another input is sharded over gets a partial gradient there.
    """
    from torch.distributed.tensor.experimental import local_map

    if grad_placements is None:
        grad_placements = replicated_grads(mesh, in_placements)
    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=grad_placements, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def replicated_grads(mesh, in_placements, partial_axes=()):
    """Gradient placements for `local_call`: ``Partial()`` where an input is
    replicated over a mesh axis that some other input is sharded over (each
    rank's gradient is its share of the sum) or that is in ``partial_axes``,
    else the input's own placement."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    names = mesh.mesh_dim_names
    sharded = {names[k] for p in in_placements if p is not None
               for k, q in enumerate(p) if isinstance(q, Shard)} | set(partial_axes)
    return tuple(None if p is None else
                 tuple(Partial() if isinstance(q, Replicate) and names[k] in sharded else q
                       for k, q in enumerate(p))
                 for p in in_placements)


def _resolved(x, mesh):
    """``x`` as a DTensor with no pending partial sum: a plain tensor replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not is_dtensor(x):
        return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if any(isinstance(q, Partial) for q in x.placements):
        return x.redistribute(mesh, [Replicate() if isinstance(q, Partial) else q
                                     for q in x.placements])
    return x


def einsum(equation: str, *operands):
    """``torch.einsum``, and for DTensor operands a sharded einsum.

    Off a mesh, or with no DTensor operand, this is ``torch.einsum``.  On
    DTensors each mesh axis keeps one einsum letter sharded: the letter
    of the largest operand sharded over it; the other operands' shards
    over that axis are gathered (the FSDP weight all-gather), and an
    operand lacking the letter's shard but holding the letter is sliced.
    Each rank then runs ``torch.einsum`` on its shards; a kept letter in
    the output is a shard of it, a contracted one a partial sum that the
    caller's `with_logical_constraint` (or the next op) reduces.  Pending
    partial sums of the operands are reduced first.  DTensor's own einsum
    goes through views that cannot unflatten a sharded head dim.
    """
    if not _MESHES or not any(is_dtensor(o) for o in operands):
        return torch.einsum(equation, *operands)
    from torch.distributed.tensor import Partial, Replicate, Shard

    lhs, out = equation.replace(" ", "").split("->")
    ins = lhs.split(",")
    mesh = next(o for o in operands if is_dtensor(o)).device_mesh
    names = mesh.mesh_dim_names
    operands = [_resolved(o, mesh) for o in operands]
    keep = {}
    for a in names:
        best = None
        for letters, o in zip(ins, operands):
            if not is_dtensor(o):
                continue
            dim = sharded_dims(o).get(a)
            letter = None if dim is None else letters[dim]
            if letter is not None and (best is None or o.numel() > best[0]):
                best = (o.numel(), letter)
        if best is not None:
            keep[a] = best[1]
    in_place = tuple(tuple(Shard(letters.index(keep[a])) if a in keep and keep[a] in letters
                           else Replicate() for a in names) for letters in ins)
    out_place = [Shard(out.index(keep[a])) if a in keep and keep[a] in out
                 else Partial() if a in keep else Replicate() for a in names]
    return local_call(lambda *local: torch.einsum(equation, *local), mesh, out_place,
                      in_place, *operands)


def matmul(x, w):
    """``x @ w`` for ``x`` (..., k) and ``w`` (k, n); a sharded `einsum` on DTensors."""
    if not _MESHES or not (is_dtensor(x) or is_dtensor(w)):
        return x @ w
    lead = "abcdefghij"[:x.dim() - 1]
    return einsum(f"{lead}k,kn->{lead}n", x, w)

"""Sharding rules: logical→physical mapping with divisibility guards; the
counterpart of ``repro.distributed.sharding`` on ``torch.distributed``.

Axes convention, as in the reference:
  * ``data axes``  — batch / token parallelism: ``("data",)`` single-pod,
    ``("pod", "data")`` multi-pod (outer DP over pods).
  * ``model axis`` — tensor/expert parallelism: ``"model"``.

A spec is a :class:`P`: one entry per tensor dimension, each ``None``, a mesh
axis name or a tuple of names (major to minor), compared as the reference's
``PartitionSpec`` is, trailing ``None`` entries dropped.  The rules
(``_filter_axes``, ``_axis_size``, ``_sanitize``, ``spec_for_path``,
``zero_extend``) read only a mesh's axis names and sizes, so they run on a
``torch.distributed.DeviceMesh``, on the port's
:class:`~repro_torch.launch.mesh.AbstractMesh` (a plan with no process group)
and on anything with a ``shape`` mapping and ``axis_names``.
:func:`placements` is the one place a spec becomes DTensor placements.

``constrain`` redistributes a ``DTensor`` activation to its sanitized spec,
dropping mesh axes that do not divide the dimension (4 KV heads on a 16-way
model axis stay replicated); it returns a plain tensor, or any tensor when no
mesh context is installed, unchanged.

The reference's rules see its *stacked* parameters, whose layers share one
tensor with a leading layer dimension; the port keeps a tensor per layer.
``param_sharding_rules`` therefore evaluates each rule on the leaf's
reference shape (``models/convert.py``'s layout) and drops the layer entries
for the per-layer tensor: a (L, E, d, ffe) ``moe_wi`` is expert-parallel
there, where a rule on the per-layer (E, d, ffe) shape would shard d.
Where the reference's ``zero_extend`` shards the layer dimension itself over
the data axes (a layer count the data size divides), the per-layer tensor,
which has no such dimension, takes ``zero_extend`` of its own shape
(``train/state.py::state_shardings``).
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch


class P(tuple):
    """A partition spec: per-dimension entries, ``None``, an axis name or a
    tuple of names. Equal to another spec (or tuple) when both agree after
    their trailing ``None`` entries are dropped, as ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (tuple(e) if isinstance(e, list) else e
                                     for e in entries))

    def _trimmed(self) -> tuple:
        entries = tuple(self)
        while entries and entries[-1] is None:
            entries = entries[:-1]
        return entries

    def __eq__(self, other):
        if not isinstance(other, tuple):
            return NotImplemented
        return self._trimmed() == P(*other)._trimmed()

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        return hash(self._trimmed())

    def __repr__(self):
        return f"P{tuple(self)!r}" if len(self) != 1 else f"P({self[0]!r})"


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh order, of a ``DeviceMesh`` or of a mesh
    with a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def mesh_size(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


@dataclass
class MeshContext:
    mesh: Any
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"

    @property
    def data_size(self) -> int:
        shape = mesh_shape(self.mesh)
        return int(math.prod(shape[a] for a in self.data_axes))

    @property
    def model_size(self) -> int:
        return int(mesh_shape(self.mesh)[self.model_axis])


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh; the counterpart of ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: P


_ctx = threading.local()


def set_mesh_context(ctx: Optional[MeshContext]) -> None:
    _ctx.value = ctx


def current_mesh() -> Optional[MeshContext]:
    return getattr(_ctx, "value", None)


def _filter_axes(ctx: MeshContext, axis):
    """Keep only axes present in the mesh (('pod','data') on a single-pod
    mesh degrades to ('data',))."""
    names = set(mesh_shape(ctx.mesh))
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in names)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return axis if axis in names else None


def _axis_size(ctx: MeshContext, axis) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(ctx.mesh)
    if isinstance(axis, (tuple, list)):
        return int(math.prod(shape[a] for a in axis))
    return int(shape[axis])


def _sanitize(ctx: MeshContext, shape: Sequence[int], spec) -> P:
    """Drop mesh-absent axes and spec axes that do not divide their dim."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    clean = []
    for dim, axis in zip(shape, entries):
        axis = _filter_axes(ctx, axis)
        if axis is None:
            clean.append(None)
            continue
        size = _axis_size(ctx, axis)
        clean.append(axis if size > 0 and dim % size == 0 else None)
    while clean and clean[-1] is None:
        clean.pop()
    return P(*clean)


def placements(mesh, spec, shape: Optional[Sequence[int]] = None) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension:
    ``Shard(d)`` on each mesh axis that tensor dim d's entry names,
    ``Replicate()`` on the rest. A tuple entry shards its dim over its axes
    major to minor, which DTensor reads in mesh order, so the tuple must
    list them in mesh order. Given the tensor's ``shape``, a dim of extent 1
    stays whole (``_sanitize`` leaves it sharded only over axes of one
    device, which split nothing): DTensor cannot view a sharded singleton
    dim away, as a matmul's flatten of a one-group batch does."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None or (shape is not None and shape[dim] == 1):
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order "
                             f"{tuple(names)}; DTensor shards a dim major to minor "
                             f"in mesh order")
        for i in order:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} appears twice in {spec!r}")
            out[i] = Shard(dim)
    return tuple(out)


def is_distributed(x) -> bool:
    """Whether ``x`` is a ``DTensor``."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def on_local_shard(fn, x, dims: Sequence[int], what: str):
    """``fn(x)``, an op that keeps x's shape, for a DTensor ``x`` run on its
    local shard and rewrapped
    under x's placements (for an op DTensor has no rule for), which needs
    each of ``dims`` whole on every rank and no pending sum, else it raises;
    a plain tensor goes to ``fn`` as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return fn(x)
    dims = {d % x.ndim for d in dims}
    for i, p in enumerate(x.placements):
        if p.is_partial() or (p.is_shard() and p.dim % x.ndim in dims
                              and x.device_mesh.size(i) > 1):
            raise ValueError(f"{what}: {tuple(x.shape)} is {p} over mesh dim {i}, and "
                             f"the op runs over dims {sorted(dims)}; redistribute it first")
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def constrain(x, *spec_entries):
    """Redistribute a ``DTensor`` to the sanitized spec; any other tensor, or
    any tensor without a mesh context, comes back unchanged (the reference
    is a no-op without a mesh)."""
    ctx = current_mesh()
    if ctx is None or not is_distributed(x):
        return x
    spec = _sanitize(ctx, x.shape, P(*spec_entries))
    target = placements(x.device_mesh, spec, x.shape)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def data_entry(ctx: MeshContext):
    """The data axes as one spec entry: a name, or a tuple of names."""
    data = tuple(ctx.data_axes)
    return data if len(data) > 1 else data[0]


def batch_shardings(specs: Mapping[str, Any], ctx: MeshContext) -> Dict[str, Any]:
    """Each input's batch dim over the data axes; a decode cache as given
    (``launch.specs`` exports it, as the reference's does)."""
    data = data_entry(ctx)

    def shard(leaf):
        spec = P(data, *([None] * (len(leaf.shape) - 1)))
        return NamedSharding(ctx.mesh, _sanitize(ctx, leaf.shape, spec))

    return {k: shard(v) if k != "cache" else v for k, v in specs.items()}


def cache_shardings(cache_specs: Mapping[str, Any], ctx: MeshContext) -> Dict[str, Any]:
    """KV caches: batch over data, sequence over model. SSM states: batch
    over data, heads over model; conv states: batch over data, channels over
    model. ``pos`` replicated."""
    data = data_entry(ctx)
    out = {}
    for name, leaf in cache_specs.items():
        nd = len(getattr(leaf, "shape", ()))
        if name in ("k", "v", "dk", "dv", "cross_k", "cross_v") and nd == 5:
            spec = P(None, data, "model", None, None)
        elif name == "ssm":
            spec = (P(None, data, "model", None, None) if nd == 5
                    else P(None, None, data, "model", None, None))
        elif name == "conv":
            spec = (P(None, data, None, "model") if nd == 4
                    else P(None, None, data, None, "model"))
        else:  # pos and misc scalars
            spec = P()
        shape = tuple(getattr(leaf, "shape", ()))
        out[name] = NamedSharding(ctx.mesh, _sanitize(ctx, shape, spec))
    return out


def on_mesh(anchor, inputs: Mapping[str, Any]):
    """(inputs, context) for a step of a model one of whose parameters is
    ``anchor``: with a mesh context set and ``anchor`` a DTensor, each plain
    input distributed by ``batch_shardings`` (``None`` kept) and
    ``implicit_replication`` (tensors the model makes, such as positions
    and masks, read as replicated); else the inputs as given, no context."""
    ctx = current_mesh()
    if ctx is None or not is_distributed(anchor):
        return dict(inputs), contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    shardings = batch_shardings({k: v for k, v in inputs.items() if v is not None}, ctx)
    return ({k: v if v is None or is_distributed(v) else distribute(v, shardings[k])
             for k, v in inputs.items()}, implicit_replication())


def gathered(w):
    """A parameter as its matmul reads it: a DTensor ``w`` with the mesh
    context's data axes replicated and its model-axis sharding kept (the
    all-gather FSDP makes before a product; its backward reduce-scatters
    the gradient). Left to DTensor, a product with an FSDP-sharded weight
    may shard its rows over the model axis as well, which gives the
    gradient rows a strided sharding a ``mm`` cannot propagate. Any other
    tensor, or any tensor without a mesh context, comes back unchanged."""
    ctx = current_mesh()
    if ctx is None or not is_distributed(w):
        return w
    from torch.distributed.tensor import Replicate

    names = list(mesh_shape(w.device_mesh))
    data = {names.index(a) for a in ctx.data_axes if a in names}
    target = tuple(Replicate() if i in data else p for i, p in enumerate(w.placements))
    return w if target == tuple(w.placements) else w.redistribute(w.device_mesh, target)


def einsum(equation: str, *operands):
    """``torch.einsum(equation, *operands)``. DTensor operands sharded on
    batch dims only (each mesh dim shards one label that every operand and
    the output have, in every operand) run on their local shards, the
    result wrapped under that label's placements: DTensor's own rule
    flattens two sharded batch dims into one (the batch of a ``bmm``) that
    it then cannot propagate. Any other product takes DTensor's rule (an
    operand replicated where another is sharded gets a gradient summed
    over that mesh dim, which the local product would not give); plain
    tensors ``torch.einsum``."""
    if not operands or not all(is_distributed(o) for o in operands):
        return torch.einsum(equation, *operands)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    ins, out = equation.replace(" ", "").split("->")
    ins = ins.split(",")
    mesh = operands[0].device_mesh
    labels: Dict[int, str] = {}
    for labs, o in zip(ins, operands):
        if o.device_mesh != mesh or "." in labs:
            return torch.einsum(equation, *operands)
        for i, p in enumerate(o.placements):
            if p.is_partial():
                return torch.einsum(equation, *operands)
            if p.is_shard() and labels.setdefault(i, labs[p.dim % o.ndim]) != labs[p.dim % o.ndim]:
                return torch.einsum(equation, *operands)
    for i, lab in labels.items():
        if lab not in out or any(lab not in labs or o.placements[i] != Shard(labs.index(lab))
                                 for labs, o in zip(ins, operands)):
            return torch.einsum(equation, *operands)
    local = torch.einsum(equation, *(o.to_local() for o in operands))
    return DTensor.from_local(local, mesh, [Shard(out.index(labels[i])) if i in labels
                                            else Replicate() for i in range(mesh.ndim)],
                              run_check=False)


def write_positions(dst, start: int, src) -> None:
    """``dst[:, start:start + n] = src`` in place, for dst (B, T, ...) and
    src (B, n, ...). A DTensor ``dst`` whose T is sharded (a cache, over the
    model axis) cannot be sliced there, so each rank writes its own shard:
    ``src`` first takes dst's placements with T whole; where n fits in a
    shard, every rank writes n slots at ``start`` less its shard's offset,
    clamped into the shard, the new positions where they are its own and
    its old ones elsewhere (a masked write, as XLA partitions a dynamic
    update of a sharded dim); a longer ``src`` (a prefill) is written over
    the part of the shard it covers."""
    n = src.shape[1]
    t_dims = ([i for i, p in enumerate(dst.placements)
               if p.is_shard() and p.dim % dst.ndim == 1] if is_distributed(dst) else [])
    if not t_dims:
        dst[:, start:start + n] = src
        return
    from torch.distributed.tensor import DTensor, Replicate

    mesh = dst.device_mesh
    whole = tuple(Replicate() if i in t_dims else p for i, p in enumerate(dst.placements))
    if not is_distributed(src):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim, run_check=False)
    src = src.redistribute(mesh, whole).to_local()
    local = dst.to_local()
    index, coordinate = 0, mesh.get_coordinate()
    for i in t_dims:  # major to minor, in mesh order
        index = index * mesh.size(i) + coordinate[i]
    tl = local.shape[1]
    off = index * tl
    if n <= tl:
        lo = min(max(start - off, 0), tl - n)
        mine = off <= start and start + n <= off + tl
        local[:, lo:lo + n] = src if mine else local[:, lo:lo + n].clone()
        return
    a, b = max(start, off), min(start + n, off + tl)
    if a < b:
        local[:, a - off:b - off] = src[:, a - start:b - start]


# ---------------------------------------------------------------------------
# Parameter sharding rules
# ---------------------------------------------------------------------------

# Rules keyed by parameter-leaf name; each gives a spec by tensor rank
# (m = model axis).  Layer-stacked tensors have a leading L dim that
# stays unsharded.
def spec_for_path(path: Tuple[str, ...], shape: Tuple[int, ...],
                  model_axis: str = "model") -> P:
    name = path[-1] if path else ""
    m = model_axis
    ndim = len(shape)

    def last(axis):  # shard the last dim
        return P(*([None] * (ndim - 1) + [axis]))

    def second_last(axis):
        if ndim < 2:
            return P()
        return P(*([None] * (ndim - 2) + [axis, None]))

    if name in ("embed",):
        return P(m, None)  # (V, d) vocab-sharded
    if name in ("lm_head",):
        return last(m)  # (d, V)
    if name in ("wq", "wk", "wv", "wi", "w_gate_up", "in_proj", "cross_wk",
                "cross_wv", "cross_wq"):
        return last(m)
    if name in ("wo", "out_proj", "cross_wo"):
        return second_last(m)
    if name in ("moe_wi",):  # (L, E, d, ffe): expert-parallel
        return P(None, m, None, None) if ndim == 4 else second_last(m)
    if name in ("moe_wo",):
        return P(None, m, None, None) if ndim == 4 else second_last(m)
    if name in ("router",):
        return P()
    if name in ("conv_w", "A_log", "D", "dt_bias"):
        return P()  # small SSM tensors: replicated
    # norms, scales, biases, positional tables: replicated
    return P()


def layer_dims(name: str, cfg) -> int:
    """The leading dims the reference stacks a port parameter's layers into:
    1, or 2 for a hybrid's (G, every, ...) ``layers``; 0 unstacked."""
    from repro_torch.models.convert import STACKED

    root = name.split(".")[0]
    if root not in STACKED:
        return 0
    return 2 if cfg.family == "hybrid" and root == "layers" else 1


def _stacked_leaves(named: Mapping[str, torch.Tensor], cfg):
    """Per port parameter name: (reference path, reference shape, layer
    dims)."""
    out = {}
    counts: Dict[tuple, int] = {}
    paths = {}
    for name in named:
        parts = name.split(".")
        paths[name] = (tuple(parts) if not layer_dims(name, cfg)
                       else (parts[0], *parts[2:]))
        counts[paths[name]] = counts.get(paths[name], 0) + 1
    for name, t in named.items():
        lead, path = layer_dims(name, cfg), paths[name]
        if lead == 0:
            out[name] = (path, tuple(t.shape), 0)
        elif lead == 2:
            every = cfg.hybrid_attn_every
            out[name] = (path, (counts[path] // every, every, *t.shape), 2)
        else:
            out[name] = (path, (counts[path], *t.shape), 1)
    return out


def stacked_param_shardings(model, mesh_ctx: MeshContext):
    """Per parameter name of ``model`` (a ``Transformer``): (NamedSharding of
    the reference's stacked leaf, its stacked shape, its layer dims).
    ``drop_layers`` turns one into the per-layer tensor's."""
    out = {}
    for name, (path, shape, lead) in _stacked_leaves(dict(model.named_parameters()),
                                                     model.cfg).items():
        spec = _sanitize(mesh_ctx, shape, spec_for_path(path, shape, mesh_ctx.model_axis))
        out[name] = (NamedSharding(mesh_ctx.mesh, spec), shape, lead)
    return out


def drop_layers(sharding: NamedSharding, shape: Sequence[int], lead: int) -> NamedSharding:
    """A stacked leaf's sharding without its ``lead`` layer entries."""
    entries = list(sharding.spec) + [None] * (len(shape) - len(sharding.spec))
    return NamedSharding(sharding.mesh, P(*entries[lead:]))


def param_sharding_rules(model, mesh_ctx: MeshContext) -> Dict[str, NamedSharding]:
    """NamedShardings by parameter name for a ``Transformer``
    (divisibility-guarded), each rule evaluated on the reference's stacked
    shape, the layer entries then dropped."""
    return {name: drop_layers(s, shape, lead) for name, (s, shape, lead)
            in stacked_param_shardings(model, mesh_ctx).items()}


def zero_extend(sharding: NamedSharding, shape: Tuple[int, ...],
                mesh_ctx: MeshContext) -> NamedSharding:
    """ZeRO/FSDP: additionally shard the first free divisible dim over the
    data axes.  No-op if the data axes are already used by the spec (a mesh
    axis may appear at most once in a spec)."""
    spec = list(sharding.spec) + [None] * (len(shape) - len(sharding.spec))
    used = set()
    for entry in spec:
        for a in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if a is not None:
                used.add(a)
    data_axes = tuple(mesh_ctx.data_axes)
    if used & set(data_axes):
        return sharding
    size = mesh_ctx.data_size
    for i, (dim, axis) in enumerate(zip(shape, spec)):
        if axis is None and dim % size == 0 and dim >= size:
            spec[i] = data_axes if len(data_axes) > 1 else data_axes[0]
            return NamedSharding(mesh_ctx.mesh, P(*spec))
    return sharding


def local_shape_and_offset(shape: Sequence[int], mesh, spec,
                           coordinate: Sequence[int]) -> Tuple[tuple, tuple]:
    """The local shape and global offset of the shard at mesh ``coordinate``
    (one index per mesh axis) of a tensor of ``shape`` under ``spec``: each
    dim split evenly over its entry's axes, major to minor."""
    sizes = mesh_shape(mesh)
    names = list(sizes)
    local, offset = list(shape), [0] * len(shape)
    for dim, entry in enumerate(list(spec) + [None] * (len(shape) - len(spec))):
        if entry is None:
            continue
        index = 0
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            index = index * sizes[a] + coordinate[names.index(a)]
        ways = _axis_size(MeshContext(mesh), entry)
        local[dim] = shape[dim] // ways
        offset[dim] = index * local[dim]
    return tuple(local), tuple(offset)


def empty_sharded(shape: Sequence[int], dtype: torch.dtype, sharding: NamedSharding):
    """An uninitialised DTensor of ``shape`` on the sharding's ``DeviceMesh``
    and placements, of which this rank allocates its own shard only."""
    from torch.distributed.tensor import empty

    return empty(*shape, dtype=dtype, device_mesh=sharding.mesh,
                 placements=placements(sharding.mesh, sharding.spec, shape))


def distribute(t: torch.Tensor, sharding: NamedSharding):
    """``t`` as a DTensor on the sharding's ``DeviceMesh`` and placements."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, sharding.mesh,
                             placements(sharding.mesh, sharding.spec, t.shape))


"""Logical-axis sharding rules over a one-process device mesh.

The JAX package's ``repro/distributed/sharding.py``.  Model and serving
code name the *logical* axes of a tensor ("kv", "heads", "batch", ...);
:class:`Sharder` resolves them against a mesh into a partition spec, one
entry per dimension (None, a mesh axis name, or a tuple of them -- the
entries of the reference's ``PartitionSpec``).  Resolution drops an axis
when the dimension is not divisible by the mesh axis' extent (8 KV heads on
a 16-way "model" axis), which replicates the tensor along that axis: always
correct.

The mesh is one process's: an array of ``torch.device`` with axis names,
the counterpart of the reference's single-controller ``jax.make_mesh``.  A
device may repeat in it when the caller passes it so (as the reference's
``--xla_force_host_platform_device_count`` makes eight CPU devices out of
one), which is how one card runs a ``1x8`` mesh: every shard is a tensor
of its own on that card and every per-shard kernel call is a launch of its
own.  :meth:`Sharder.place` turns a tensor into a :class:`ShardedTensor`,
the global shape, the spec and one local tensor per mesh position; a shard
that two positions on one device hold alike (a replicated one, above all)
is one storage, not a copy.  :meth:`Sharder.constrain` to a replicated spec
is the all-gather: the global tensor, assembled on the mesh's first device
-- pure data movement, never a sum.

What lives on the mesh is what the caller places there.  The serving stack
(:func:`serving_sharder`) places only its KV pools, split on KV heads; the
one controller keeps everything replicated once, on the mesh's first device,
and runs it there once (the reference's replicated computations are the
same on every device).  Training places the parameters and the optimizer
state (:func:`layout`), and the expert-parallel MoE runs per position with
the reference's collectives over per-position locals: :func:`all_to_all`
along one axis, :func:`pmean` over axes, and :meth:`ShardedTensor.full` /
:meth:`Sharder.relayout`, through which autograd goes back (the gradient
of a gather is the full gradient cut into the shards' slices).  Every local
lies on its position's device: a CPU tensor in a mesh of CUDA devices
raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs.telemetry import get_telemetry

# logical name -> candidate mesh axes (in priority order; tuples mean "use
# all that exist, jointly")
DEFAULT_RULES = {
    None: None,
    "replicated": None,
    "layers": None,
    "batch": ("pod", "data"),          # data parallel axis (both pods)
    "seq": ("model",),                 # Megatron-SP sequence sharding
    "vocab": ("model",),
    "heads": ("model",),               # flattened (H*dh) or head axis
    "kv": ("model",),
    "ff": ("model",),
    "expert": ("model",),
    "inner": ("model",),               # mamba d_inner / ssd heads
    "fsdp": ("pod", "data"),           # ZeRO-3 style weight shard
    "embed": None,                     # d_model of activations
    # decode KV-cache sequence axis: split-K over "model"; falls through to
    # "data" when batch=1 frees it
    "kvseq": ("model", "data"),
}

# Serving shards only head-like axes.  Everything else stays replicated, so
# the only cross-shard merges are gathers (pure data movement) -- never a
# sum whose float reassociation would break bitwise token-exactness with
# the single-device engine.
SERVING_RULES = {
    "heads": ("model",),
    "kv": ("model",),
}

Spec = Tuple[Any, ...]            # per dimension: None, "axis" or ("a", "b")
Slices = Tuple[slice, ...]


class Mesh:
    """Devices laid out on named axes: ``devices`` is a numpy object array
    of ``torch.device`` of shape ``tuple(shape.values())``.  Positions are
    numbered row-major over that array (:meth:`position_devices`)."""

    def __init__(self, devices: Sequence[Any], shape: Sequence[int],
                 axis_names: Sequence[str]):
        shape = tuple(int(n) for n in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} for axes {axis_names}")
        devs = [torch.device(d) for d in devices]
        if len(devs) != math.prod(shape):
            raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                             f"devices, given {len(devs)}")
        arr = np.empty(len(devs), dtype=object)
        arr[:] = devs
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def position_devices(self) -> List[torch.device]:
        """The device of every mesh position, row-major."""
        return list(self.devices.reshape(-1))

    def coords(self, position: int) -> Dict[str, int]:
        """Axis name -> index of flat ``position`` along that axis."""
        idx = np.unravel_index(position, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.position_devices()})"


def _entry_axes(entry: Any) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_index_map(mesh: Mesh, spec: Spec, shape: Sequence[int]
                   ) -> List[Slices]:
    """The global slices each mesh position holds of a ``shape`` tensor
    placed by ``spec`` (the reference's ``devices_indices_map``): a
    dimension split over axes ``(a, b)`` is cut into ``|a| * |b|`` equal
    pieces, numbered row-major over those axes."""
    out: List[Slices] = []
    for p in range(mesh.size):
        at = mesh.coords(p)
        sl = []
        for entry, dim in zip(spec, shape):
            axes = _entry_axes(entry)
            n, i = 1, 0
            for a in axes:
                n, i = n * mesh.shape[a], i * mesh.shape[a] + at[a]
            if dim % n:
                raise ValueError(f"dimension {dim} does not split {n} ways "
                                 f"(spec {spec})")
            step = dim // n
            sl.append(slice(i * step, (i + 1) * step))
        out.append(tuple(sl))
    return out


def same_device(a: torch.device, b: torch.device) -> bool:
    """One device, where an index left out is the type's current one."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def storage_key(t: torch.Tensor) -> Tuple:
    return (str(t.device), t.data_ptr(), tuple(t.shape), tuple(t.stride()))


@dataclasses.dataclass
class ShardedTensor:
    """A global tensor of ``shape`` held as one local tensor per mesh
    position (``locals[p]`` holds the global slices ``slices[p]``, on
    ``mesh.position_devices()[p]``).  Positions holding the same slices on
    one device share one storage."""
    shape: Tuple[int, ...]
    spec: Spec
    mesh: Mesh
    locals: List[torch.Tensor]
    slices: List[Slices]

    def __post_init__(self):
        for dev, t in zip(self.mesh.position_devices(), self.locals):
            if not same_device(t.device, dev):
                raise ValueError(f"a local on {t.device} at a mesh position "
                                 f"on {dev}")

    @classmethod
    def from_locals(cls, mesh: Mesh, spec: Spec,
                    locals_: Sequence[torch.Tensor]) -> "ShardedTensor":
        """Wrap per-position locals laid out by ``spec``; the global shape
        follows from the locals' shape and the spec's shard counts."""
        first = locals_[0]
        shape = tuple(int(d) * math.prod(mesh.shape[a]
                                         for a in _entry_axes(e))
                      for d, e in zip(first.shape, spec))
        return cls(shape, tuple(spec), mesh, list(locals_),
                   spec_index_map(mesh, spec, shape))

    @property
    def dtype(self) -> torch.dtype:
        return self.locals[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def unique(self) -> List[Tuple[int, torch.Tensor, Slices]]:
        """``(first position, local, slices)`` of every distinct storage, in
        position order: a write goes to each once, a read needs one."""
        seen, out = set(), []
        for p, (t, sl) in enumerate(zip(self.locals, self.slices)):
            key = storage_key(t)
            if key not in seen:
                seen.add(key)
                out.append((p, t, sl))
        return out

    def map(self, fn, spec: Optional[Spec] = None) -> "ShardedTensor":
        """``fn`` applied to every distinct local (shared storages stay
        shared); the result is laid out by ``spec`` (default: this one's)."""
        done: Dict[Tuple, torch.Tensor] = {}
        new = []
        for t in self.locals:
            key = storage_key(t)
            if key not in done:
                done[key] = fn(t)
            new.append(done[key])
        return ShardedTensor.from_locals(self.mesh, self.spec
                                         if spec is None else spec, new)

    def __getitem__(self, i: int) -> "ShardedTensor":
        """The views at index ``i`` of a leading axis that is not split (a
        stage of a stacked pool)."""
        if not isinstance(i, int) or self.spec[0] is not None:
            raise IndexError("a ShardedTensor takes an int index on an "
                             "unsplit leading axis only")
        return self.map(lambda t: t[i], self.spec[1:])

    def numel(self) -> int:
        return math.prod(self.shape)

    def distinct(self) -> List[Tuple[int, torch.Tensor, Slices]]:
        """``(first position, local, slices)`` of every distinct slice set,
        in position order: what a reduction over the global tensor reads
        once (two devices holding one slice set are one term)."""
        seen, out = set(), []
        for p, (t, sl) in enumerate(zip(self.locals, self.slices)):
            key = tuple((s.start, s.stop) for s in sl)
            if key not in seen:
                seen.add(key)
                out.append((p, t, sl))
        return out

    def full(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the mesh's first
        device), assembled from the distinct shards -- a concatenation when
        one axis is split.  Autograd goes back through it: each distinct
        shard's gradient is the full gradient's slice."""
        device = torch.device(device) if device is not None else \
            self.mesh.position_devices()[0]
        parts: Dict[Tuple, torch.Tensor] = {}     # (start, stop) a dim
        for _, t, sl in self.unique():
            parts.setdefault(tuple((s.start, s.stop) for s in sl), t)
        split = [d for d in range(self.ndim)
                 if len({key[d] for key in parts}) > 1]
        if not split:
            return next(iter(parts.values())).to(device)
        if len(split) == 1:
            d = split[0]
            return torch.cat([parts[k].to(device) for k in
                              sorted(parts, key=lambda k: k[d])], dim=d)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for key, t in parts.items():
            out[tuple(slice(a, b) for a, b in key)].copy_(t)
        return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Mesh
    spec: Spec


class Sharder:
    """Resolves logical axis tuples to partition specs for one mesh.

    ``fsdp=False`` maps the "fsdp" logical axis to None (weights replicated
    across data); ``seq_shard=False`` disables activation sequence
    sharding.  ``mesh=None`` is the single-device path: every spec is
    replicated and :meth:`place` / :meth:`constrain` are the identity."""

    def __init__(self, mesh: Optional[Mesh], *, fsdp: bool = False,
                 seq_shard: bool = False, rules: Optional[dict] = None):
        self.mesh = mesh
        self.rules = dict(rules or DEFAULT_RULES)
        if not fsdp:
            self.rules["fsdp"] = None
        if not seq_shard:
            self.rules["seq"] = None

    # ------------------------------------------------------------------
    def _axes_for(self, logical: Optional[str], dim: int,
                  used: frozenset = frozenset()) -> Optional[Tuple[str, ...]]:
        if self.mesh is None or logical is None:
            return None
        cand = self.rules.get(logical, None)
        if cand is None:
            return None
        if isinstance(cand, str):
            cand = (cand,)
        axes = tuple(a for a in cand
                     if a in self.mesh.axis_names and a not in used)
        if not axes:
            return None
        extent = math.prod(self.mesh.shape[a] for a in axes)
        if dim % extent != 0:
            # try progressively smaller suffixes (drop "pod", keep "data")
            for i in range(1, len(axes)):
                sub = axes[i:]
                if dim % math.prod(self.mesh.shape[a] for a in sub) == 0:
                    return sub
            return None
        return axes

    def spec(self, logical: Sequence[Optional[str]], shape: Sequence[int]
             ) -> Spec:
        """One entry per dimension: None, a mesh axis, or a tuple of them."""
        if len(logical) != len(shape):
            raise ValueError(f"logical axes {tuple(logical)} for shape "
                             f"{tuple(shape)}")
        used: set = set()
        parts = []
        for name, dim in zip(logical, shape):
            axes = self._axes_for(name, dim, frozenset(used))
            if axes is None:
                parts.append(None)
                continue
            used.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
        return tuple(parts)

    def named(self, logical: Sequence[Optional[str]], shape: Sequence[int]
              ) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.spec(logical, shape))

    def extent(self, logical: Optional[str], dim: int) -> int:
        """Number of shards the rules would split a ``dim``-sized axis
        into."""
        axes = self._axes_for(logical, dim)
        if axes is None:
            return 1
        return math.prod(self.mesh.shape[a] for a in axes)

    def index_map(self, logical: Sequence[Optional[str]],
                  shape: Sequence[int]) -> List[Slices]:
        """The global slices each mesh position holds of a ``shape`` tensor
        placed by ``logical``; one full slice set off-mesh."""
        if self.mesh is None:
            return [tuple(slice(0, int(d)) for d in shape)]
        return spec_index_map(self.mesh, self.spec(logical, shape), shape)

    # ------------------------------------------------------------------
    def _note_place(self, spec: Spec, shape, nbytes: int) -> None:
        tel = get_telemetry(None)
        if tel.enabled:
            tel.count("shard.placements")
            tel.count("shard.placed_bytes", nbytes)
            tel.event("shard.place", spec=str(spec),
                      shape=tuple(int(d) for d in shape),
                      mesh=dict(self.mesh.shape))

    def place(self, x: torch.Tensor, logical: Sequence[Optional[str]]):
        """``x`` split onto the mesh by the resolved spec, as a
        :class:`ShardedTensor` (each shard contiguous on its device; the
        identity off-mesh)."""
        if self.mesh is None:
            return x
        spec = self.spec(logical, x.shape)
        self._note_place(spec, x.shape, x.numel() * x.element_size())
        return layout(x, self.mesh, spec)

    def zeros(self, shape: Sequence[int], logical: Sequence[Optional[str]],
              dtype: torch.dtype):
        """A zero tensor of global ``shape`` placed by ``logical``: each
        shard allocated contiguous on its device, never the whole (a plain
        tensor off-mesh is the caller's)."""
        if self.mesh is None:
            raise ValueError("Sharder.zeros needs a mesh")
        spec = self.spec(logical, shape)
        self._note_place(spec, shape, math.prod(shape)
                         * torch.empty((), dtype=dtype).element_size())
        slices = spec_index_map(self.mesh, spec, shape)
        made: Dict[Tuple, torch.Tensor] = {}
        locals_ = []
        for dev, sl in zip(self.mesh.position_devices(), slices):
            key = (str(dev), tuple((s.start, s.stop) for s in sl))
            if key not in made:
                made[key] = torch.zeros([s.stop - s.start for s in sl],
                                        dtype=dtype, device=dev)
            locals_.append(made[key])
        return ShardedTensor(tuple(int(d) for d in shape), spec, self.mesh,
                             locals_, slices)

    def constrain(self, x, logical: Sequence[Optional[str]]):
        """``x`` laid out by ``logical`` (the identity off-mesh).  To a
        replicated spec a :class:`ShardedTensor` is gathered into the global
        tensor on the mesh's first device -- data movement, never a sum."""
        if self.mesh is None:
            return x
        spec = self.spec(logical, x.shape)
        replicated = all(e is None for e in spec)
        if isinstance(x, ShardedTensor):
            if replicated:
                return x.full()
            return x if tuple(spec) == tuple(x.spec) else \
                self.place(x.full(), logical)
        return x if replicated else self.place(x, logical)


    def place_named(self, x: torch.Tensor, named: Optional[NamedSharding]):
        """``x`` laid out by a :class:`NamedSharding` of this mesh (the
        reference's ``device_put(x, sharding)``; the identity for None)."""
        if named is None:
            return x
        self._note_place(named.spec, x.shape, x.numel() * x.element_size())
        return layout(x, named.mesh, named.spec)

    def relayout(self, x, spec: Spec) -> "ShardedTensor":
        """``x`` (a tensor or a :class:`ShardedTensor`) laid out by the
        partition ``spec``: a sharded ``x`` is gathered first (the
        reference's ``with_sharding_constraint`` between two specs, as the
        fsdp gather of expert weights).  Autograd goes back through it."""
        if isinstance(x, ShardedTensor):
            if tuple(x.spec) == tuple(spec):
                return x
            x = x.full()
        return layout(x, self.mesh, spec)


def layout(x: torch.Tensor, mesh: Mesh, spec: Spec) -> ShardedTensor:
    """``x`` cut by ``spec`` onto ``mesh``: one contiguous local for each
    distinct (device, slices), which the positions holding it share.
    Autograd goes back through it: ``x``'s gradient is the sum of the
    locals' gradients, each put back at its slices (the reduce-scatter's
    transpose)."""
    slices = spec_index_map(mesh, spec, x.shape)
    made: Dict[Tuple, torch.Tensor] = {}
    locals_ = []
    for dev, sl in zip(mesh.position_devices(), slices):
        key = (str(dev), tuple((s.start, s.stop) for s in sl))
        if key not in made:
            made[key] = x[sl].to(dev).contiguous()
        locals_.append(made[key])
    return ShardedTensor(tuple(x.shape), tuple(spec), mesh, locals_, slices)


def axis_groups(mesh: Mesh, axes: Sequence[str]) -> List[List[int]]:
    """For every position, the positions that differ from it only along
    ``axes``, in row-major order over those axes (its collective group)."""
    shape = mesh.devices.shape
    out = []
    for p in range(mesh.size):
        at = list(np.unravel_index(p, shape))
        dims = [mesh.axis_names.index(a) for a in axes]
        group = []
        for idx in np.ndindex(*(shape[d] for d in dims)):
            for d, i in zip(dims, idx):
                at[d] = i
            group.append(int(np.ravel_multi_index(at, shape)))
        out.append(group)
    return out


def all_to_all(mesh: Mesh, locals_: Sequence[torch.Tensor], axis: str
               ) -> List[torch.Tensor]:
    """The reference's ``all_to_all(x, axis, split_axis=0, concat_axis=0,
    tiled=False)`` over per-position locals, each with a leading dimension
    of ``axis``' extent: position ``p`` at coordinate ``c`` receives
    ``stack(locals_[q][c] for q in its group)``, on its own device.
    Autograd goes back through the exchange."""
    groups = axis_groups(mesh, (axis,))
    devs = mesh.position_devices()
    out = []
    for p, group in enumerate(groups):
        c = group.index(p)
        out.append(torch.stack([locals_[q][c].to(devs[p]) for q in group]))
    return out


def pmean(mesh: Mesh, values: Sequence[torch.Tensor],
          axes: Optional[Sequence[str]] = None) -> List[torch.Tensor]:
    """The reference's ``pmean`` over ``axes`` (default: every axis) of
    per-position values: each group's values summed in position order on
    its first position's device, over the group's size, and handed to every
    member on its device."""
    groups = axis_groups(mesh, tuple(mesh.axis_names if axes is None
                                     else axes))
    devs = mesh.position_devices()
    done: Dict[Tuple[int, ...], torch.Tensor] = {}
    out = []
    for p, group in enumerate(groups):
        key = tuple(group)
        if key not in done:
            d0 = devs[group[0]]
            total = values[group[0]]
            for q in group[1:]:
                total = total + values[q].to(d0)
            done[key] = total / len(group)
        out.append(done[key].to(devs[p]))
    return out


def home_device(x) -> torch.device:
    """A tensor's device; a placed tensor's mesh's first device (where it
    is gathered and its replicated companions live)."""
    return (x.mesh.position_devices()[0] if isinstance(x, ShardedTensor)
            else x.device)


def null_sharder() -> Sharder:
    return Sharder(None)


def parse_mesh(spec: Optional[str], devices: Optional[Sequence[Any]] = None
               ) -> Optional[Mesh]:
    """A mesh from an ``AxB`` spec string ("1x8", "2x4", "1x1").

    Two extents map to ("data", "model"), three to ("pod", "data",
    "model"), a bare integer to a 1xN ("data", "model") mesh; None or empty
    gives None (the single-device path, no mesh).  ``devices`` default to
    the visible CUDA devices; the first ``A*B`` of them are used, and a
    device may repeat in the list.  Raises ``ValueError`` when the spec
    needs more devices than there are."""
    if not spec:
        return None
    extents = tuple(int(p) for p in str(spec).lower().split("x"))
    names = {1: ("data", "model"), 2: ("data", "model"),
             3: ("pod", "data", "model")}[len(extents)]
    if len(extents) == 1:
        extents = (1,) + extents
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n_dev = math.prod(extents)
    if n_dev > len(devices):
        raise ValueError(
            f"mesh {spec} needs {n_dev} devices, have {len(devices)}")
    return Mesh(devices[:n_dev], extents, names)


def serving_sharder(mesh: Optional[Mesh]) -> Sharder:
    """Sharder for the serving stack: KV-head partitioning only."""
    return Sharder(mesh, rules=SERVING_RULES)


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def param_shardings(sharder: Sharder, axes_tree: Any, shapes_tree: Any):
    """Axes tree + tree of tensors (or shapes) -> tree of
    :class:`NamedSharding` (None off-mesh)."""
    if _is_axes(axes_tree):
        shape = getattr(shapes_tree, "shape", shapes_tree)
        return sharder.named(axes_tree, tuple(shape))
    if isinstance(axes_tree, dict):
        return {k: param_shardings(sharder, v, shapes_tree[k])
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(param_shardings(sharder, a, s)
                               for a, s in zip(axes_tree, shapes_tree))
    raise TypeError(f"axes tree leaf {axes_tree!r}")

"""Device meshes over ``torch.distributed``. Port of
``distkeras_tpu/parallel/mesh.py``.

The JAX package places one program over a ``jax.sharding.Mesh`` and lets
XLA insert the collectives. The port runs one process a device (a rank)
and names the mesh's axes on a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks: :class:`Mesh` gives this rank its coordinate on every axis
and one process group an axis, and the collectives are explicit. Every
rank runs the same host loop over the same seeded data, the JAX package's
multi-controller design (``put_global`` there, :func:`put_global` here:
each rank places only its own shard of a host array). A leaf's place on
the mesh is a :class:`LeafLayout`: its global shape and partition spec
(a mesh-axis name or None a dim), this rank's piece, and that piece's
blocks at their global starts (what a process-sharded checkpoint
writes).

A mesh of one rank needs no launcher: when no process group exists, it
makes a world of one itself over a ``HashStore`` (NCCL on the card, gloo
on the CPU) and destroys it again on :meth:`Mesh.close`. A larger mesh
needs a world that ``job_deployment.initialize_cluster`` (or the caller)
brought up, and spans all of it: a mesh larger or smaller than the world
raises.

The differentiable collectives of the strategies live here too, each an
``autograd.Function`` whose backward is the forward's transpose:
:func:`copy_to` and :func:`reduce_from` (Megatron's conjugate pair),
:func:`gather_from` / :func:`split_to` (a replicated value split along a
dim and gathered back), :func:`gather_shards` (FSDP's all-gather, whose
backward reduce-scatters) and :func:`all_to_all`. Each is the identity
when its axis is not on the mesh.

The mesh's axes and the ranks' groups are also what the models read while
a strategy runs (:func:`using`, :func:`context`): the tensor-parallel
layers, ring attention and the sequence-parallel embedding and head.
"""

from __future__ import annotations

import contextlib
import itertools
import threading

import numpy as np
import torch
import torch.distributed as dist

from distkeras_tpu_torch import utils


def _device_for_rank(device) -> torch.device:
    dev = utils.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", rank % max(1, torch.cuda.device_count()))
    return dev


def _world_of_one(device: torch.device) -> None:
    """A process group of this process alone, over an in-memory store."""
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1,
                            **kw)


class Mesh:
    """A named N-D mesh of ranks (``{"dp": 2, "tp": 2}``; the dict order is
    the axis order, the last axis the fastest-varying rank). ``shape``
    maps each axis to its size, as the JAX mesh's; :meth:`size`,
    :meth:`index` and :meth:`group` answer for axes not on the mesh too
    (size 1, index 0, no group)."""

    def __init__(self, axes: dict, device="cuda"):
        sizes = [int(s) for s in axes.values()]
        if not sizes or min(sizes) < 1:
            raise ValueError(f"mesh {axes}: every axis needs a size >= 1")
        need = int(np.prod(sizes))
        self.owns_world = False
        if not dist.is_initialized():
            if need != 1:
                raise ValueError(
                    f"mesh {axes} needs {need} ranks, but no process group "
                    f"exists: start one per device (job_deployment."
                    f"initialize_cluster) first")
            self.device = _device_for_rank(device)
            _world_of_one(self.device)
            self.owns_world = True
        else:
            self.device = _device_for_rank(device)
        world = dist.get_world_size()
        if need > world:
            raise ValueError(f"mesh {axes} needs {need} devices, have {world}")
        if need < world:
            # the trainers' collectives (the global-norm clip, the host
            # gather, a checkpoint's barriers) span the whole world
            raise ValueError(f"mesh {axes} spans {need} of the world's "
                             f"{world} ranks; a mesh takes every rank")
        from torch.distributed.device_mesh import DeviceMesh

        self.shape = dict(zip(axes, sizes))
        self.axis_names = tuple(axes)
        self.rank = dist.get_rank()
        self.device_mesh = DeviceMesh(
            self.device.type, torch.arange(need).reshape(sizes),
            mesh_dim_names=self.axis_names)
        coord = self.device_mesh.get_coordinate()
        if coord is None:
            raise ValueError(f"rank {self.rank} lies outside mesh {axes}")
        self._index = dict(zip(self.axis_names, coord))
        self._groups = {a: self.device_mesh.get_group(a)
                        for a in self.axis_names}

    def size(self, axis) -> int:
        return self.shape.get(axis, 1) if axis is not None else 1

    def index(self, axis) -> int:
        return self._index.get(axis, 0) if axis is not None else 0

    def group(self, axis):
        """The process group of ``axis`` through this rank, or None when
        the axis is not on the mesh."""
        return self._groups.get(axis) if axis is not None else None

    def close(self) -> None:
        """Destroy the world of one this mesh made (a no-op otherwise)."""
        if self.owns_world and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_world = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def get_mesh(num_workers: int | None = None, device="cuda",
             axis: str = "dp") -> Mesh:
    """The 1-D data-parallel mesh over ``num_workers`` ranks (default: the
    whole world, or one rank when there is none)."""
    if num_workers is None:
        num_workers = dist.get_world_size() if dist.is_initialized() else 1
    return Mesh({axis: int(num_workers)}, device=device)


def worker_slice(mesh: Mesh, num_workers: int) -> slice:
    """This rank's workers of the global ``num_workers`` when W workers
    run over the ranks of the ``"dp"`` axis (one card a rank): the
    contiguous ``[index · W/dp, (index + 1) · W/dp)``. W must be a multiple
    of the axis size and at least it (the JAX package builds a sub-mesh
    when W is smaller; a mesh here takes every rank), and the mesh may
    have no other axis of more than one rank (W workers are data parallel
    only)."""
    W, dp = int(num_workers), mesh.size("dp")
    extra = {a: n for a, n in mesh.shape.items() if a != "dp" and n > 1}
    if extra:
        raise ValueError(
            f"W workers over processes run on a 'dp'-only mesh; this mesh "
            f"also has {extra} (use MeshTrainer for one model over tensor, "
            f"pipeline, sequence or expert axes)")
    if W < dp:
        raise ValueError(
            f"num_workers={W} is smaller than the mesh axis 'dp' of {dp} "
            f"ranks: every rank holds at least one worker (a mesh takes "
            f"every rank; start fewer processes)")
    if W % dp:
        raise ValueError(
            f"num_workers={W} is not a multiple of the mesh axis 'dp' of "
            f"{dp} ranks: each rank holds an equal share of the workers")
    n = W // dp
    lo = mesh.index("dp") * n
    return slice(lo, lo + n)


def mesh_info(mesh: Mesh) -> dict:
    dev = mesh.device
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {
        "num_devices": int(np.prod(list(mesh.shape.values()))),
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device_kind": kind,
        "axis_names": list(mesh.axis_names),
        "num_hosts": dist.get_world_size(),
        "backend": dist.get_backend(),
    }


def full_spec(spec, ndim: int) -> tuple:
    """``spec`` padded with ``None`` to ``ndim`` entries."""
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


class LeafLayout:
    """Where one leaf lives: its global shape and spec, and this rank's
    piece of it. A dim named by an axis is cut into equal contiguous
    chunks, except the q | k | v dim of a fused projection under
    ``tp_axis``, which is cut head-wise inside each of its parts."""

    def __init__(self, shape, spec, mesh, tp_axis: str = "tp",
                 qkv=None):
        self.shape = tuple(int(s) for s in shape)
        self.spec = full_spec(spec, len(self.shape))
        self.mesh = mesh
        self.axes = tuple(a for a in self.spec if a is not None)
        self.qkv = qkv if tp_axis in self.axes else None
        self.qkv_dim = self.spec.index(tp_axis) if self.qkv else None
        for d, a in enumerate(self.spec):
            k = mesh.size(a)
            parts = self.qkv if d == self.qkv_dim else (self.shape[d],)
            if any(p % k for p in parts):
                raise ValueError(f"dim {d} of {self.shape} does not split "
                                 f"over mesh axis {a!r} of size {k}")

    def dim_of(self, axis):
        return self.spec.index(axis) if axis in self.spec else None

    def _ranges(self, d):
        """``[(global start, local start, length)]`` of dim ``d``."""
        a = self.spec[d]
        n = self.shape[d]
        k, i = self.mesh.size(a), self.mesh.index(a)
        if a is None:
            return [(0, 0, n)]
        if d != self.qkv_dim:
            return [(i * (n // k), 0, n // k)]
        out, g0, l0 = [], 0, 0
        for part in self.qkv:
            out.append((g0 + i * (part // k), l0, part // k))
            g0, l0 = g0 + part, l0 + part // k
        return out

    def local_shape(self) -> tuple:
        return tuple(sum(r[2] for r in self._ranges(d))
                     for d in range(len(self.shape)))

    def local(self, value) -> torch.Tensor:
        """This rank's piece of the global ``value`` (host), contiguous."""
        t = value if isinstance(value, torch.Tensor) else torch.as_tensor(
            np.asarray(value))
        out = torch.empty(self.local_shape(), dtype=t.dtype)
        for g_sl, l_sl in self._piece_slices():
            out[l_sl] = t[g_sl]
        return out

    def _piece_slices(self):
        dims = [self._ranges(d) for d in range(len(self.shape))]
        for combo in itertools.product(*dims):
            yield (tuple(slice(g, g + n) for g, _, n in combo),
                   tuple(slice(l, l + n) for _, l, n in combo))

    def pieces(self, local) -> list:
        """``[(global starts, numpy block)]`` of this rank's piece."""
        arr = local.detach().cpu()
        if arr.dtype == torch.bfloat16:
            arr = arr.to(torch.float32)
        arr = arr.numpy()
        return [(tuple(s.start for s in g_sl), arr[l_sl])
                for g_sl, l_sl in self._piece_slices()]

    def writes(self) -> bool:
        """Whether this rank writes the leaf in a sharded checkpoint: the
        first rank along every axis the leaf is replicated over."""
        return all(self.mesh.index(a) == 0 for a in self.mesh.axis_names
                   if a not in self.axes)

    def replicas(self) -> int:
        return int(np.prod([self.mesh.size(a) for a in self.mesh.axis_names
                            if a not in self.axes]))


def put_global(array, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of a host array (every rank holds the whole
    value) under ``spec`` (a tuple of axis names or None a dim; shorter
    tuples leave the trailing dims whole; each named dim cut into equal
    contiguous chunks), as a contiguous tensor on the mesh's device."""
    t = array if isinstance(array, torch.Tensor) else torch.as_tensor(
        np.asarray(array))
    return LeafLayout(t.shape, spec, mesh).local(t).to(mesh.device)


# -- collectives ------------------------------------------------------------

def _gsize(group) -> int:
    return dist.get_world_size(group) if group is not None else 1


def _all_gather(x, group, dim: int):
    n = _gsize(group)
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x, group, dim: int):
    n = _gsize(group)
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, x, group=group)
    return out.movedim(0, dim)


def _all_reduce(x, group):
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _slice(x, group, dim: int):
    n, i = _gsize(group), dist.get_rank(group)
    k = x.shape[dim] // n
    return x.narrow(dim, i * k, k).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(x, group, dim):
        return _all_gather(x, group, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim), None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(x, group, dim):
        return _slice(x, group, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(x, group, dim):
        return _all_gather(x, group, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


def _a2a(x, group, split_dim: int, concat_dim: int):
    """``jax.lax.all_to_all(tiled=True)``: ``split_dim`` cut into one
    chunk a rank, chunk r sent to rank r, the received chunks concatenated
    along ``concat_dim`` in rank order."""
    inp = torch.stack(x.chunk(_gsize(group), dim=split_dim)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(x, group, split_dim, concat_dim):
        return _a2a(x, group, split_dim, concat_dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.split, ctx.concat = inputs[1], inputs[2], inputs[3]

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group, ctx.concat, ctx.split), None, None, None


def copy_to(x, group):
    """Identity forward, all-reduce backward: a replicated value entering
    work split over ``group`` (before a column-parallel layer)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """All-reduce forward, identity backward: partial sums leaving work
    split over ``group`` (after a row-parallel layer)."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x, group, dim: int):
    """All-gather along ``dim`` forward, this rank's slice backward: the
    pieces of a value every rank then uses whole and alike."""
    return x if group is None else _GatherFrom.apply(x, group, dim)


def split_to(x, group, dim: int):
    """This rank's slice along ``dim`` forward, all-gather backward: a
    replicated value cut into the ranks' pieces."""
    return x if group is None else _SplitTo.apply(x, group, dim)


def gather_shards(x, group, dim: int):
    """All-gather forward, reduce-scatter (sum) backward: FSDP's parameter
    gather over ranks that each ran other data."""
    return x if group is None else _GatherShards.apply(x, group, dim)


def all_to_all(x, group, split_dim: int, concat_dim: int):
    """Differentiable tiled all-to-all; its backward is the reverse
    exchange."""
    return x if group is None else _AllToAll.apply(x, group, split_dim,
                                                   concat_dim)


def all_reduce_(x, group, op=None) -> torch.Tensor:
    """In-place all-reduce (sum unless ``op``), no autograd; a no-op
    without a group."""
    if group is not None:
        dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    return x


def shift(tensors, group, offset: int) -> list:
    """Every rank sends ``tensors`` ``offset`` places along ``group``
    (mod its size) and returns what arrives from ``-offset`` places: one
    batched exchange, no autograd."""
    n = _gsize(group)
    if group is None or offset % n == 0:
        return list(tensors)
    me = dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    dst, src = ranks[(me + offset) % n], ranks[(me - offset) % n]
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), dst) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, src) for o in outs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


# -- the strategy context the models read -------------------------------------

class MeshContext:
    """What a model's forward needs of the mesh while a strategy runs it:
    the tensor-parallel group and size, the sequence-parallel group, this
    rank's index on it and its size, and the expert-parallel group."""

    def __init__(self, tp_group=None, sp_group=None, ep_group=None):
        self.ep_group = ep_group
        self.tp_group = tp_group
        self.tp_size = _gsize(tp_group)
        self.sp_group = sp_group
        self.sp_size = _gsize(sp_group)
        self.sp_index = dist.get_rank(sp_group) if sp_group is not None \
            else 0


_LOCAL = threading.local()
_NONE = MeshContext()


def context() -> MeshContext:
    """The active :class:`MeshContext` of this thread (an inert one when
    no strategy runs)."""
    return getattr(_LOCAL, "ctx", None) or _NONE


@contextlib.contextmanager
def using(ctx: MeshContext | None):
    prev = getattr(_LOCAL, "ctx", None)
    _LOCAL.ctx = ctx
    try:
        yield ctx
    finally:
        _LOCAL.ctx = prev


__all__ = ["LeafLayout", "Mesh", "MeshContext", "all_reduce_", "all_to_all",
           "context", "copy_to", "full_spec", "gather_from", "gather_shards",
           "get_mesh", "mesh_info", "put_global", "reduce_from", "shift",
           "split_to", "using", "worker_slice"]

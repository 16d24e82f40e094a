"""Tensor parallelism and the SPMD engine: one model trained over a mesh.
Port of ``distkeras_tpu/parallel/tensor.py``.

The JAX package annotates shardings and lets GSPMD insert the collectives.
The port keeps the annotations and writes the collectives:

- A partition spec is a tuple with a mesh-axis name or ``None`` a tensor
  dim (shorter tuples leave the trailing dims whole). It describes the
  *global* tensor in the port's layout (``weight [out, in]``) exactly as
  the JAX spec describes flax's (``kernel [in, out]``):
  :func:`megatron_specs` puts ``qkv`` and ``mlp_up`` column-parallel,
  ``attn_out`` and ``mlp_down`` row-parallel and the ``embed`` table
  vocab-parallel over ``tp``; everything else is replicated.
- Megatron's conjugate operators (``mesh.copy_to`` before a
  column-parallel layer, ``mesh.reduce_from`` after a row-parallel one,
  the row-parallel bias added once after the reduce) run inside the
  layers while :class:`SPMDEngine` holds the tensor-parallel
  ``mesh.MeshContext``: ``models/layers.py::Dense`` and ``embed_lookup``.
- The fused ``qkv`` projection is ``[3·dim, dim]``, q | k | v. Its spec
  splits the rows contiguously, as the JAX spec does, but the rank that
  computes heads ``r·H/tp …`` needs rows of q, of k and of v alike: the
  rank holds head slice r of each (:class:`LeafLayout`), and specs and
  checkpoints stay in the global layout.
- Data parallelism: every rank takes the mean loss over its ``B/dp`` rows
  and the gradients are averaged over ``dp`` (a mean over the global
  batch, for equal shares). ``grad_accum=A`` sums the gradients of A
  equal microbatches and divides by A; microbatch ``a`` of rank ``d`` is
  rows ``a·B/A + d·B/(A·dp) …`` of the global batch, the JAX package's
  ``P(None, dp)`` layout of ``[A, B/A]``.

The engine differentiates with plain autograd on the rank's local leaves
(one model: no worker axis to ``vmap``); the optimizer runs on the local
shards, so its moments are partitioned like the parameters (ZeRO's
optimizer-state partitioning under FSDP specs).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from distkeras_tpu_torch.parallel import mesh as mesh_mod
from distkeras_tpu_torch.parallel.mesh import (
    LeafLayout,
    Mesh,
    full_spec,
    put_global,
)

#: layer name → Megatron role of its Dense
_MEGATRON_ROLES = {"qkv": "column", "mlp_up": "column",
                   "attn_out": "row", "mlp_down": "row"}


def get_mesh_nd(axes: dict, device="cuda") -> Mesh:
    """An N-D mesh, e.g. ``get_mesh_nd({"dp": 2, "tp": 2})``, over the
    ranks of the current world (a world of one when there is none and the
    mesh asks for one rank)."""
    return Mesh(axes, device=device)


def megatron_specs(params: dict, tp_axis: str = "tp") -> dict:
    """The Megatron partition spec of every leaf of a ``{name: tensor}``
    tree (the transformer families' layer names)."""
    def spec_for(name, leaf):
        parts = name.split(".")
        last, nd = parts[-1], len(leaf.shape)
        for k in parts:
            role = _MEGATRON_ROLES.get(k)
            if role is not None:
                if last == "weight" and nd == 2:
                    return (tp_axis, None) if role == "column" \
                        else (None, tp_axis)
                if last == "bias" and nd == 1:
                    return (tp_axis,) if role == "column" else ()
            if k == "embed" and last == "weight" and nd == 2:
                return (tp_axis, None)   # vocab-parallel table
        return ()

    return {n: spec_for(n, v) for n, v in params.items()}


def shard_pytree(tree: dict, mesh: Mesh, specs: dict) -> dict:
    """Every leaf's contiguous shard under its spec, on this rank's
    device (``mesh.put_global``)."""
    return {n: put_global(v, specs[n], mesh) for n, v in tree.items()}


def _qkv_sizes(module, name: str):
    """The q | k | v row counts of a fused ``qkv`` leaf, or None."""
    parts = name.split(".")
    if module is None or "qkv" not in parts:
        return None
    owner = module.get_submodule(".".join(parts[:parts.index("qkv")]))
    heads = int(getattr(owner, "heads"))
    kv = int(getattr(owner, "hkv", heads))
    dh = int(getattr(owner, "dh", 0)) or None
    if dh is None:
        width = owner.qkv.weight.shape[0]
        return (width // 3,) * 3
    return (heads * dh, kv * dh, kv * dh)


def _gather_pieces(per_leaf: dict, layouts: dict, dtypes: dict) -> dict:
    """Global numpy arrays from every rank's pieces (one object gather
    when the world has more than one rank)."""
    mine = {n: layouts[n].pieces(t) for n, t in per_leaf.items()}
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world > 1:
        everyone = [None] * world
        dist.all_gather_object(everyone, mine)
    else:
        everyone = [mine]
    out = {}
    for n, lay in layouts.items():
        if n not in per_leaf:
            continue
        arr = np.zeros(lay.shape, dtypes[n])
        for rank_pieces in everyone:
            for starts, block in rank_pieces[n]:
                arr[tuple(slice(s, s + b) for s, b in
                          zip(starts, block.shape))] = block
        out[n] = arr
    return out


def _np_dtype(t: torch.Tensor):
    return np.float32 if t.dtype == torch.bfloat16 else \
        torch.empty((), dtype=t.dtype).numpy().dtype


def param_like(node, names) -> bool:
    return isinstance(node, dict) and set(node) == set(names) and bool(names)


def map_param_like(tree, names, fn, other):
    """``fn(subtree)`` on every dict keyed by the parameter names (the
    optimizer's moments), ``other(leaf)`` on every other leaf."""
    if param_like(tree, names):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_param_like(v, names, fn, other)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(map_param_like(v, names, fn, other)
                            for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_param_like(v, names, fn, other) for v in tree)
    return other(tree)


class ShardedLeaf:
    """One leaf of a process-sharded checkpoint: its global shape and
    dtype, this rank's pieces, and whether this rank writes them."""

    def __init__(self, shape, dtype, pieces, write: bool):
        self.shape, self.dtype = tuple(shape), np.dtype(dtype)
        self.pieces, self.write = pieces, write


class SPMDEngine:
    """Synchronous training of ONE model over a (dp, tp) mesh: data
    parallelism over ``dp`` and Megatron tensor parallelism over ``tp``.
    The math equals single-device training on the global batch.

    ``loss_step(params, nt, batch) -> (loss, new_nt)`` as elsewhere, on
    this rank's rows. ``param_specs`` overrides the layout; leaves sharded
    over ``tp`` must be Megatron's (the layers know no other split).
    ``sum_axes`` names the axes whose ranks split the work on replicated
    leaves into partial gradients (a strategy's sequence or pipeline
    axis): those gradients are summed over them. ``clipnorm`` clips the
    global norm of the whole gradient, over every shard.
    """

    def __init__(self, spec, loss_step, optimizer, mesh: Mesh,
                 param_specs=None, dp_axis: str = "dp", tp_axis: str = "tp",
                 grad_accum: int = 1, clipnorm=None, sum_axes=()):
        self.spec = spec
        self.loss_step = loss_step
        self.optimizer = optimizer
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.tp_axis = tp_axis
        self.grad_accum = int(grad_accum)
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.param_specs = param_specs
        self.clipnorm = None if clipnorm is None else float(clipnorm)
        self.sum_axes = tuple(a for a in sum_axes if a in mesh.shape)
        self.device = mesh.device
        self.layouts: dict = {}
        self.context = (mesh_mod.MeshContext(tp_group=mesh.group(tp_axis))
                        if tp_axis in mesh.shape else None)
        self._rows: dict = {}

    # -- layout ---------------------------------------------------------------

    def _default_specs(self, params) -> dict:
        if self.tp_axis in self.mesh.shape:
            return megatron_specs(params, self.tp_axis)
        return {n: () for n in params}

    def _resolve_specs(self, params) -> None:
        if self.param_specs is None:
            self.param_specs = self._default_specs(params)
        module = getattr(self.spec, "module", None)
        megatron = megatron_specs(params, self.tp_axis)
        layouts = {}
        for n, v in params.items():
            s = full_spec(self.param_specs.get(n, ()), len(v.shape))
            unknown = [a for a in s if a is not None
                       and a not in self.mesh.shape]
            if unknown:
                raise ValueError(f"{n}: spec {s} names axes {unknown} not "
                                 f"on the mesh {self.mesh.shape}")
            tp_dims = [d for d, a in enumerate(s) if a == self.tp_axis]
            want = [d for d, a in enumerate(full_spec(megatron[n],
                                                      len(v.shape)))
                    if a == self.tp_axis]
            if tp_dims and tp_dims != want:
                raise ValueError(
                    f"{n}: spec {s} splits it over {self.tp_axis!r} where "
                    f"the Megatron layers do not; tensor parallelism runs "
                    f"the Megatron layout only")
            layouts[n] = LeafLayout(
                v.shape, s, self.mesh, self.tp_axis,
                qkv=_qkv_sizes(module, n) if tp_dims else None)
        if (self.mesh.size(self.tp_axis) > 1
                and getattr(module, "tie_embeddings", False)):
            raise ValueError(
                "tie_embeddings=True under tensor parallelism (tp > 1): the "
                "tied head would contract against one vocab shard; train "
                "an untied LM or tp=1")
        self.layouts = layouts

    def _place(self, params) -> dict:
        return {n: self.layouts[n].local(v).to(self.device)
                .requires_grad_(True) for n, v in params.items()}

    def _place_nt(self, nt) -> dict:
        return {k: torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v).to(self.device) for k, v in nt.items()}

    def init_state(self, params, nt):
        """Place the global host ``params`` (every rank holds them) as
        this rank's shards; the optimizer state starts on those shards."""
        self._resolve_specs(params)
        local = self._place(params)
        opt = self.optimizer.init({n: p.detach() for n, p in local.items()})
        return local, self._place_nt(nt), opt

    def place_state(self, params, nt, opt_state):
        """Place restored global host state (the resume path): params and
        the optimizer's parameter-shaped subtrees as this rank's shards."""
        from distkeras_tpu_torch.utils import tree_like

        self._resolve_specs(params)
        local = self._place(params)
        names = list(local)
        template = self.optimizer.init({n: p.detach()
                                        for n, p in local.items()})
        opt = map_param_like(
            opt_state, names,
            lambda sub: {n: self.layouts[n].local(sub[n]) for n in names},
            lambda x: x)
        return local, self._place_nt(nt), tree_like(opt, template,
                                                     self.device)

    def gather_params(self, params) -> dict:
        """The global host (numpy) value of every leaf."""
        dtypes = {n: _np_dtype(p) for n, p in params.items()}
        return _gather_pieces({n: p.detach() for n, p in params.items()},
                              self.layouts, dtypes)

    def gather_tree(self, tree):
        """A training-state tree in the global layout on the host: the
        parameter-shaped subtrees gathered, every other leaf copied."""
        names = list(self.layouts)
        return map_param_like(tree, names, self.gather_params, _host)

    def sharded_tree(self, tree):
        """The tree with every parameter-shaped leaf a
        :class:`ShardedLeaf` of this rank's pieces (a ``.dks`` save)."""
        names = list(self.layouts)

        def leaves(sub):
            return {n: ShardedLeaf(self.layouts[n].shape, _np_dtype(t),
                                   self.layouts[n].pieces(t),
                                   self.layouts[n].writes())
                    for n, t in sub.items()}

        return map_param_like(tree, names, leaves, _host)

    # -- data -----------------------------------------------------------------

    def _check_batch(self, B: int) -> None:
        dp = self.mesh.size(self.dp_axis)
        if B % dp:
            raise ValueError(f"global batch size {B} not divisible by mesh "
                             f"axis '{self.dp_axis}' of size {dp}")
        if B % (self.grad_accum * dp):
            raise ValueError(
                f"global batch size {B} not divisible by grad_accum "
                f"{self.grad_accum} × dp {dp} = {self.grad_accum * dp}")

    def local_rows(self, B: int) -> np.ndarray:
        """This rank's rows of a global batch of ``B``, microbatch-major."""
        if B not in self._rows:
            A, dp = self.grad_accum, self.mesh.size(self.dp_axis)
            d = self.mesh.index(self.dp_axis)
            self._rows[B] = np.arange(B).reshape(A, dp, B // (A * dp))[
                :, d].reshape(-1)
        return self._rows[B]

    def place_batch(self, batch_arrays: tuple) -> tuple:
        """Host batch ``[B, …]`` → this rank's rows on its device."""
        self._check_batch(batch_arrays[0].shape[0])
        rows = self.local_rows(batch_arrays[0].shape[0])
        return tuple(torch.from_numpy(np.ascontiguousarray(
            np.asarray(a)[rows])).to(self.device) for a in batch_arrays)

    def stage_epoch(self, col_arrays: tuple) -> tuple:
        """The full columns ``[N, …]`` on this rank's device (every rank
        holds every row; each step takes its own)."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in col_arrays)

    # -- the step -------------------------------------------------------------

    def _compute_params(self, params) -> dict:
        """The leaves as the forward uses them: ``dp``-sharded (FSDP)
        leaves all-gathered, every other leaf this rank's own piece."""
        g = self.mesh.group(self.dp_axis)
        out = {}
        for n, p in params.items():
            d = self.layouts[n].dim_of(self.dp_axis)
            out[n] = p if d is None else mesh_mod.gather_shards(p, g, d)
        return out

    def _forward_backward(self, params, nt, batch):
        with mesh_mod.using(self.context):
            loss, new_nt = self.loss_step(self._compute_params(params), nt,
                                          batch)
            loss.backward()
        return loss.detach(), {k: v.detach() for k, v in new_nt.items()}

    def _reduce_axes(self, name) -> tuple:
        axes = self.layouts[name].axes
        out = [a for a in (self.dp_axis,) + self.sum_axes
               if a in self.mesh.shape and a not in axes]
        return tuple(dict.fromkeys(out))

    def _sync_grads(self, params) -> dict:
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        buckets: dict = {}
        for n, g in grads.items():
            buckets.setdefault((self._reduce_axes(n), g.dtype), []).append(n)
        for (axes, _), names in buckets.items():
            if not axes:
                continue
            flat = torch.cat([grads[n].reshape(-1) for n in names])
            for a in axes:
                mesh_mod.all_reduce_(flat, self.mesh.group(a))
            for n, piece in zip(names, flat.split(
                    [grads[n].numel() for n in names])):
                grads[n] = piece.view_as(grads[n])
        scale = 1.0 / (self.grad_accum * self.mesh.size(self.dp_axis))
        return {n: g * scale for n, g in grads.items()}

    def _clip(self, grads) -> dict:
        sq = sum(torch.sum(torch.square(g.to(torch.float32)))
                 / self.layouts[n].replicas() for n, g in grads.items())
        sq = torch.as_tensor(sq, device=self.device).reshape(1)
        if dist.get_world_size() > 1:
            dist.all_reduce(sq)
        norm = torch.sqrt(sq[0])
        c = self.clipnorm
        return {n: torch.where(norm < c, g, (g / norm.to(g.dtype)) * c)
                for n, g in grads.items()}

    def _sync_nt(self, nt) -> dict:
        g = self.mesh.group(self.dp_axis)
        dp = self.mesh.size(self.dp_axis)
        if g is None or dp == 1:
            return nt
        out = {}
        for k, v in nt.items():
            if torch.is_floating_point(v):
                v = mesh_mod.all_reduce_(v.clone(), g) / dp
            out[k] = v
        return out

    def _step(self, params, nt, opt_state, local_batch):
        for p in params.values():
            p.grad = None
        A = self.grad_accum
        parts = [x.chunk(A) for x in local_batch]
        loss_sum = None
        for a in range(A):
            loss, nt = self._forward_backward(params, nt,
                                              tuple(x[a] for x in parts))
            loss_sum = loss if loss_sum is None else loss_sum + loss
        grads = self._sync_grads(params)
        if self.clipnorm is not None:
            grads = self._clip(grads)
        with torch.no_grad():
            updates, opt_state = self.optimizer.update(
                grads, opt_state, {n: p.detach() for n, p in params.items()})
            names = list(params)
            torch._foreach_add_([params[n] for n in names],
                                [updates[n].to(params[n].dtype)
                                 for n in names])
        for p in params.values():
            p.grad = None
        loss = (loss_sum / A).to(torch.float32).reshape(1)
        g = self.mesh.group(self.dp_axis)
        if g is not None:
            mesh_mod.all_reduce_(loss, g)
            loss = loss / self.mesh.size(self.dp_axis)
        return params, self._sync_nt(nt), opt_state, loss[0]

    def run_step(self, params, nt, opt_state, batch_arrays: tuple):
        """One global-batch step; ``batch_arrays`` host arrays ``[B, …]``
        (every rank passes the whole batch) or :meth:`place_batch`'s
        output. Returns ``(params, nt, opt_state, loss)``, the loss the
        global batch's mean."""
        if not isinstance(batch_arrays[0], torch.Tensor):
            batch_arrays = self.place_batch(batch_arrays)
        return self._step(params, nt, opt_state, batch_arrays)

    def run_epoch_resident(self, params, nt, opt_state, staged: tuple,
                           batch_size: int, shuffle_seed):
        """One epoch over :meth:`stage_epoch`'s columns, every step's rows
        taken on the device (shuffled by a ``torch.Generator`` seeded with
        ``shuffle_seed``, the same permutation on every rank). Rows past
        the last full batch are dropped. Returns ``(params, nt,
        opt_state, losses[S])``."""
        B = int(batch_size)
        self._check_batch(B)
        rows = staged[0].shape[0]
        order = (torch.randperm(rows, generator=torch.Generator()
                                .manual_seed(int(shuffle_seed)))
                 if shuffle_seed is not None else torch.arange(rows))
        local = torch.from_numpy(self.local_rows(B))
        losses = []
        for s in range(rows // B):
            idx = order[s * B:(s + 1) * B][local].to(self.device)
            batch = tuple(c.index_select(0, idx) for c in staged)
            params, nt, opt_state, loss = self._step(params, nt, opt_state,
                                                     batch)
            losses.append(loss)
        return params, nt, opt_state, torch.stack(losses)


def _host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.to(torch.float32) if x.dtype == torch.bfloat16
                else x).numpy()
    return x


def assert_param_shardings(params: dict, specs: dict, mesh: Mesh,
                           shapes: dict) -> None:
    """Test helper: every local leaf has the shape its spec gives it of
    the global ``shapes``."""
    for n, p in params.items():
        want = LeafLayout(shapes[n], specs[n], mesh).local_shape()
        if tuple(p.shape) != want:
            raise AssertionError(f"{n}: local shape {tuple(p.shape)} != "
                                 f"{want} (spec {specs[n]} of "
                                 f"{tuple(shapes[n])})")


def embed_lookup(table, tokens):
    """Rows of an embedding table, vocab-parallel under a tensor-parallel
    context: this rank's table holds rows ``r·V/tp …``, tokens outside it
    give zeros, and the ranks' rows are summed (``mesh.reduce_from``)."""
    tokens = tokens.to(torch.int64)
    g = mesh_mod.context().tp_group
    if g is None:
        return F.embedding(tokens, table)
    n = table.shape[0]
    local = tokens - dist.get_rank(g) * n
    valid = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), table)
    return mesh_mod.reduce_from(rows * valid[..., None].to(rows.dtype), g)


def parallel_linear(x, weight, bias, role, dtype):
    """``F.linear`` in ``dtype`` with a Megatron ``role`` ("column",
    "row" or None) under the active tensor-parallel context."""
    g = mesh_mod.context().tp_group if role else None
    b = None if bias is None else bias.to(dtype)
    if g is None:
        return F.linear(x.to(dtype), weight.to(dtype), b)
    if role == "column":
        return F.linear(mesh_mod.copy_to(x, g).to(dtype), weight.to(dtype), b)
    y = mesh_mod.reduce_from(F.linear(x.to(dtype), weight.to(dtype)), g)
    return y if b is None else y + b


def tp_heads(heads: int, role) -> int:
    """Heads this rank computes: ``heads / tp`` under a tensor-parallel
    context (a ``column`` qkv), else all of them."""
    ctx = mesh_mod.context()
    if role is None or ctx.tp_group is None:
        return heads
    if heads % ctx.tp_size:
        raise ValueError(f"{heads} heads do not split over tp of size "
                         f"{ctx.tp_size}")
    return heads // ctx.tp_size


__all__ = ["SPMDEngine", "ShardedLeaf", "assert_param_shardings",
           "embed_lookup",
           "get_mesh_nd", "map_param_like", "megatron_specs",
           "parallel_linear", "shard_pytree", "tp_heads"]

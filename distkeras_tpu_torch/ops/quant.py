"""Int8 weight-only quantization for serving, on PyTorch + CUDA.

Port of ``distkeras_tpu/ops/quant.py``: symmetric absmax int8 per output
channel. Decode is bound by weight bytes, so int8 weights halve the bytes
each decode step streams; the widening to the activation type has to happen
after the read, inside the kernel (``csrc/quant.cu``), or a dequantized copy
would cost the bytes back.

Layout differs from the JAX package on purpose: a :class:`QTensor` that
feeds :func:`q_matmul` holds ``q [N, K]`` — one row per output channel, as
``nn.Linear.weight`` — which is the layout the kernel streams. The JAX
package keeps ``[K, N]``; ``convert.params_from_jax`` transposes.

:func:`quantize_serving` is the generic int8 serving door for any spec of
the zoo: the ``models.layers.Dense`` modules its forward reaches are
served through :func:`q_matmul` by a module swap.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import functools
from collections.abc import Mapping
from typing import NamedTuple

import torch
from torch import nn

from distkeras_tpu_torch.model import per_thread
from distkeras_tpu_torch.ops import _build


class QTensor(NamedTuple):
    """An int8-quantized matrix ``q`` with per-output-channel ``scale``
    (f32); the represented value is ``q.float() * scale`` along the output
    axis. For :func:`q_matmul`, ``q`` is ``[N, K]`` and ``scale`` ``[N]``."""

    q: torch.Tensor
    scale: torch.Tensor


def quantize(w, axis: int = 0) -> QTensor:
    """Symmetric absmax int8 quantization of a 2-D weight; ``axis`` is the
    reduction (input) dimension, so scales are per output channel. ``q``
    keeps ``w``'s layout. Bit-identical to the JAX package's ``quantize``."""
    w = torch.as_tensor(w)
    if w.ndim != 2:
        raise ValueError(f"quantize expects a 2-D weight, got {tuple(w.shape)}")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=axis)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(wf / scale.unsqueeze(axis))
    q = q.clamp(-127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def dequantize(qt: QTensor, axis: int = 0, dtype=torch.float32):
    """Materialize the represented weight (tests and debugging only)."""
    return (qt.q.to(torch.float32) * qt.scale.unsqueeze(axis)).to(dtype)


def _q_matmul_plain(x2, q, scale, out_dtype):
    """Plain version of the kernel: widen the weight, accumulate in f32
    (int8 and bf16 values are exact in f32, so this is the kernel's
    arithmetic up to summation order), scale the accumulator, cast."""
    acc = torch.matmul(x2.to(torch.float32), q.to(torch.float32).t())
    return (acc * scale).to(out_dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

DECODE_M = 16           # rows that take a decode kernel
SMS = 132               # streaming multiprocessors of an H100 SXM
CHUNK = 64              # k per pipeline stage of the wgmma prefill kernel
DECODE_CHUNK = 128      # ... and of the split decode kernel
DECODE_CHANNELS = 32    # output channels per block of the split decode kernel
TOKEN_TILES = (64, 128, 192, 256)   # the wgmma prefill kernel's token widths
MAX_DECODE_SPLITS = 8   # blocks of one K split: a portable cluster
MAX_SPLITS = 3          # ... of a prefill split (more cost more than they give)

# dk_q_matmul's path codes
_PATHS = {"f32": 0, "decode_direct": 1, "decode": 2, "prefill_direct": 3,
          "prefill": 4}


class MatmulPlan(NamedTuple):
    """How :func:`q_matmul`'s kernel covers an ``[M, K] x [N, K]`` product:
    ``kernel`` (``"decode"``/``"prefill"`` split K over a cluster of
    ``splits`` blocks; ``"decode_direct"``/``"prefill_direct"`` the element-
    masked kernels for shapes that TMA and cp.async rows cannot take;
    ``"f32"``), the block's ``channels`` and ``tokens`` (its output tile),
    ``wg`` (the prefill kernel's consumer warpgroups), ``grid`` (blocks
    along channels, tokens and K) and ``chunk`` (the k a pipeline stage
    holds: the K split hands out whole chunks)."""

    kernel: str
    channels: int
    tokens: int
    wg: int
    splits: int
    grid: tuple
    chunk: int = CHUNK

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def chunk_range(rank: int, splits: int, chunks: int) -> tuple[int, int]:
    """The K chunks ``[lo, hi)`` that block ``rank`` of a K split sums
    (the kernels compute the same floor division)."""
    return rank * chunks // splits, (rank + 1) * chunks // splits


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _prefill_cost(m, n, k, tn, wg, splits):
    """Relative time of a prefill plan: its waves of blocks, each loading
    a block's chunks of x (tn tokens, bf16) and q (64 wg channels, int8),
    which bound the kernel on the card, plus a K split's reduction of the
    f32 partial tile through distributed shared memory."""
    blocks = _cdiv(n, 64 * wg) * _cdiv(m, tn) * splits
    per_block = (_cdiv(_cdiv(k, CHUNK), splits) * (tn * 128 + wg * 4096)
                 + (splits > 1) * tn * 64 * wg * 2)
    return _cdiv(blocks, SMS) * per_block


@functools.lru_cache(maxsize=4096)
def plan_q_matmul(m: int, n: int, k: int, dtype=torch.bfloat16,
                  aligned: bool = True) -> MatmulPlan:
    """The launch plan for ``x [m, k] @ q [n, k]ᵀ``: a pure function of the
    shape, the dtype and whether x and q are 16-byte aligned.

    Decode (m <= 16) is bound by the weight bytes: split K so that at least
    two blocks run per SM. Prefill is bound by the bytes each SM takes in
    per chunk, and a block fills an SM: the plan takes the token tile,
    channel tile (128 or 64) and K split (at most ``MAX_SPLITS``, and only
    within one wave of blocks) whose waves of blocks load the fewest bytes
    (``_prefill_cost``; PERF.md gives the measurements it was fitted
    to)."""
    if dtype == torch.float32:
        return MatmulPlan("f32", 64, 64, 0, 1, (_cdiv(n, 64), _cdiv(m, 64), 1))
    if not (aligned and k % 16 == 0):
        if m <= DECODE_M:
            return MatmulPlan("decode_direct", 16, m, 0, 1, (_cdiv(n, 16), 1, 1))
        return MatmulPlan("prefill_direct", 128, 64, 0, 1,
                          (_cdiv(n, 128), _cdiv(m, 64), 1))
    if m <= DECODE_M:
        tiles = _cdiv(n, DECODE_CHANNELS)
        splits = max(1, min(MAX_DECODE_SPLITS, _cdiv(k, DECODE_CHUNK),
                            _cdiv(2 * SMS, tiles)))
        return MatmulPlan("decode", DECODE_CHANNELS, m, 0, splits,
                          (tiles, 1, splits), DECODE_CHUNK)
    most = min(MAX_SPLITS, _cdiv(k, CHUNK))
    tn, wg, splits = min(
        ((tn, wg, s) for tn in TOKEN_TILES for wg in (2, 1)
         for s in range(1, most + 1)
         if s == 1 or _cdiv(n, 64 * wg) * _cdiv(m, tn) * s <= SMS),
        key=lambda o: (_prefill_cost(m, n, k, *o), -o[0], -o[1], o[2]))
    return MatmulPlan("prefill", 64 * wg, tn, wg, splits,
                      (_cdiv(n, 64 * wg), _cdiv(m, tn), splits))


def _bind(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dk_q_matmul.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, i, vp]
    lib.dk_q_matmul.restype = i


def _q_matmul_cuda(x2, q, scale, out_dtype):
    dtype = _DTYPE_CODE.get(x2.dtype)
    if dtype is None:
        raise TypeError(f"q_matmul kernel takes float32 or bfloat16 x, got "
                        f"{x2.dtype}")
    if out_dtype != x2.dtype:
        raise TypeError(f"q_matmul kernel writes x's dtype {x2.dtype}, "
                        f"asked for {out_dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("q must be int8 and scale float32")
    if q.device != x2.device or scale.device != x2.device:
        raise ValueError("x, q and scale must lie on the same CUDA device")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("q and scale must be contiguous")
    lib = _build.load("quant", _bind)
    m, k = x2.shape
    n = q.shape[0]
    plan = plan_q_matmul(m, n, k, x2.dtype, aligned=(
        x2.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0))
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    err = lib.dk_q_matmul(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n,
        k, dtype, _PATHS[plan.kernel], plan.tokens, plan.wg, plan.splits,
        torch.cuda.current_stream(x2.device).cuda_stream,
    )
    _build.check(err, "q_matmul")
    _build.count_launch(q_matmul)
    _build.count_launch_at(q_matmul, "launches_by_rows", m)
    if plan.kernel.startswith("prefill"):
        _build.count_launch(q_matmul, "prefill_launches")
    return out


def q_matmul(x, qt: QTensor, *, out_dtype=None):
    """``x [..., K] @ dequant(qt)ᵀ → [..., N]`` with ``qt.q [N, K]``.

    On a CUDA tensor this launches the hand-written kernel
    (``csrc/quant.cu``, the path of :func:`plan_q_matmul`) — any M, K and
    N, ragged edges masked in the kernel — or raises; on a CPU tensor it
    runs the plain version. ``launches`` counts kernel launches,
    ``prefill_launches`` those of them with more than 16 rows and
    ``launches_by_rows`` them by M, the rows of ``x``."""
    n, k = qt.q.shape
    if x.shape[-1] != k:
        raise ValueError(f"x trailing dim {x.shape[-1]} != weight columns {k}")
    if qt.scale.shape != (n,):
        raise ValueError(f"scale shape {tuple(qt.scale.shape)} != ({n},)")
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if x2.shape[0] == 0:
        return torch.empty((*lead, n), dtype=out_dtype, device=x.device)
    if x.device.type == "cpu":
        out = _q_matmul_plain(x2, qt.q, qt.scale, out_dtype)
    elif x.device.type == "cuda":
        out = _q_matmul_cuda(x2.contiguous(), qt.q, qt.scale, out_dtype)
    else:
        raise ValueError(f"q_matmul runs on cpu or cuda tensors, got "
                         f"{x.device}")
    return out.reshape(*lead, n)


q_matmul.launches = 0
q_matmul.prefill_launches = 0
q_matmul.launches_by_rows = {}


class QDense(nn.Module):
    """Dense over an int8 weight-only-quantized kernel: ``kernel_q`` int8
    ``[out, in]`` (the layout :func:`q_matmul`'s kernel streams) and
    per-output-channel ``scale`` f32 as buffers, ``bias`` in
    ``param_dtype`` (``dtype`` unless given). The input is cast to the
    compute ``dtype``, the product runs through :func:`q_matmul` in it and
    the bias is added in it: the float Dense's dtypes, as the JAX package
    keeps them. The LM's int8 form (``models.lm.quantize_lm``) and
    :func:`quantize_serving` both serve through it."""

    def __init__(self, in_features: int, features: int, dtype, device=None,
                 param_dtype=None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("kernel_q", torch.zeros(
            (features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(
            features, dtype=param_dtype or dtype, device=device))

    def forward(self, x):
        dt = self.dtype
        out = q_matmul(x.to(dt), QTensor(self.kernel_q, self.scale),
                       out_dtype=dt)
        return out + self.bias.to(dt)


def _dense_paths_reached(spec, params, state) -> set:
    """Module names of the ``models.layers.Dense`` layers one forward of
    ``spec.module`` on its example input reaches (forward hooks)."""
    from distkeras_tpu_torch.models.layers import Dense

    reached: set = set()
    hooks = [m.register_forward_hook(
        lambda mod, args, out, name=name: reached.add(name))
        for name, m in spec.module.named_modules() if type(m) is Dense]
    device = next(iter(params.values())).device
    x0 = spec.example if isinstance(spec.example, tuple) else (spec.example,)
    try:
        with torch.no_grad():
            torch.func.functional_call(
                spec.module, {**params, **state},
                tuple(t.to(device) for t in x0))
    finally:
        for h in hooks:
            h.remove()
    return reached


def quantize_serving(spec, params, state=None):
    """Generic int8 weight-only serving for a spec built by
    ``model.from_module`` (the zoo): ``(spec, trained params) → (int8 spec,
    int8 params)``.

    One forward on the spec's recorded example input finds the
    ``models.layers.Dense`` modules the serving forward reaches; exactly
    those are quantized (:func:`quantize_dense_tree` with their paths:
    ``{name}.weight`` becomes ``{name}.kernel_q`` int8 ``[out, in]`` and
    ``{name}.scale``), and the returned spec's ``apply`` runs a copy of the
    module with each of them swapped for a :class:`QDense`, served by
    :func:`q_matmul` (the kernel on the card). Anything else (embeddings,
    convolutions, LayerNorms, the LSTM's scan) stays in float. The int8
    spec serves only: its ``apply`` refuses ``training=True`` and it
    carries no ``fused_losses``. ``models.quantize_lm`` stays the LM's
    door (its ``QDense`` layers also serve the cached decode paths)."""
    if getattr(spec, "module", None) is None:
        raise ValueError(
            "quantize_serving needs a spec built by model.from_module (the "
            "models/ zoo); Keras and hand-written specs have no module to "
            "swap layers in")
    if getattr(spec, "example", None) is None:
        raise ValueError(
            "quantize_serving needs the spec's example input to run the "
            "module once (ModelSpec.example, recorded by the zoo)")
    state = {} if state is None else state
    reached = _dense_paths_reached(spec, params, state)
    qmodule = copy.deepcopy(spec.module)
    tree: dict = {}
    for name in sorted(reached):
        mod = qmodule.get_submodule(name)
        node = tree
        for part in name.split("."):
            node = node.setdefault(part, {})
        node.update(kernel=params[f"{name}.weight"].t(),
                    bias=params[f"{name}.bias"])
        parent, _, child = name.rpartition(".")
        setattr(qmodule.get_submodule(parent) if parent else qmodule, child,
                QDense(mod.weight.shape[1], mod.weight.shape[0], mod.dtype,
                       param_dtype=mod.bias.dtype))
    qtree = quantize_dense_tree(
        tree, paths={tuple(name.split(".")) for name in reached})
    qparams = {k: v for k, v in params.items()
               if k.rpartition(".")[0] not in reached}
    for name in reached:
        node = qtree
        for part in name.split("."):
            node = node[part]
        qparams[f"{name}.kernel_q"] = node["kernel_q"].t().contiguous()
        qparams[f"{name}.scale"] = node["scale"]
        qparams[f"{name}.bias"] = node["bias"]
    module_here = per_thread(qmodule)

    def apply(params, state, x, training):
        if training:
            raise ValueError(
                "int8 weight-only quantization is a serving path; train "
                "the float model and re-quantize")
        inputs = x if isinstance(x, tuple) else (x,)
        out = torch.func.functional_call(module_here(), {**params, **state},
                                         inputs)
        return out, state

    qspec = dataclasses.replace(spec, apply=apply, name=spec.name + "_int8",
                                module=qmodule, fused_losses=None)
    return qspec, qparams


def quantize_dense_tree(params, paths: set | None = None):
    """Walk a flax-format param tree (nested mappings of arrays or tensors)
    and quantize Dense-shaped groups: ``{"kernel": [K, N], "bias"}`` becomes
    ``{"kernel_q": int8 [K, N], "scale": f32 [N], "bias"}`` — the same
    structure and values as the JAX package's ``quantize_dense_tree``.
    ``paths`` restricts conversion to the given subtree paths (where a
    bias-less ``{"kernel"}`` converts too); without it only exact
    ``{kernel, bias}`` pairs convert."""

    def convert(node):
        qt = quantize(node["kernel"], axis=0)
        out = {"kernel_q": qt.q, "scale": qt.scale}
        if "bias" in node:
            out["bias"] = node["bias"]
        return out

    def rec(node, path):
        if isinstance(node, Mapping):
            is_dense_shape = (
                set(node) in ({"kernel", "bias"}, {"kernel"})
                and getattr(node.get("kernel"), "ndim", 0) == 2
            )
            if paths is not None:
                if path in paths and is_dense_shape:
                    return convert(node)
            elif set(node) == {"kernel", "bias"} and is_dense_shape:
                return convert(node)
            return {k: rec(v, path + (k,)) for k, v in node.items()}
        return node

    return rec(params, ())

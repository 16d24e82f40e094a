"""Commit-payload compression for the asynchronous parameter-server path.

The port's own copy of ``distkeras_tpu/parallel/compression.py`` (numpy).
Two lossy codecs compress the commit direction (worker → PS), combined with
worker-side error feedback (Seide et al. 2014; Karimireddy et al. 2019):
the part of each window delta the codec dropped is added to the next
window's delta, so the transmitted stream telescopes to the true one.

- :class:`Int8Codec` — symmetric per-leaf absmax int8 (4× fewer bytes).
- :class:`TopKCodec` — magnitude top-k per leaf (default 5%).

Codecs encode a tree into a wire-safe blob of plain dicts/lists of numpy
arrays and primitives, which travels the restricted-pickle frames
(``networking.py``) unchanged; the PS decodes before folding
(:func:`maybe_decode`). The pull direction compresses separately
(``pull_compression="int8"``, with the residual held by the server).

The port's PS trees are f32 and integer numpy: an extended float dtype
name (``bfloat16``, ``float8_*``) on the wire raises ``TypeError`` here.
"""

from __future__ import annotations

from typing import Any

import numpy as np

Pytree = Any

#: blob key marking an encoded commit (never a param name in any model tree)
_MARK = "__dk_codec__"
_LEAF = "__dk_leaf__"


class Codec:
    """Commit-payload codec: ``encode(tree) → wire blob``, ``decode`` back.

    ``decode(encode(t))`` is the *transmitted* (lossy) tree — workers use it
    to compute the error-feedback residual; the PS folds exactly it.
    """

    name: str = "identity"
    #: leaves smaller than this pass through uncompressed (header overhead
    #: beats the savings); the native int8 wire sets 1 — every float leaf
    #: must ride the segmented wire
    min_size: int = 16

    def encode_leaf(self, arr: np.ndarray) -> dict:
        raise NotImplementedError

    def decode_leaf(self, blob: dict) -> np.ndarray:
        raise NotImplementedError

    # -- tree plumbing (structure travels as plain containers) --------------

    def encode(self, tree: Pytree) -> dict:
        def rec(node):
            if isinstance(node, dict):
                return {k: rec(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                enc = [rec(v) for v in node]
                return enc if isinstance(node, list) else tuple(enc)
            arr = np.asarray(node)
            # any floating dtype compresses (bf16/f16 via an f32 staging
            # cast; the original dtype is restored on decode so the PS fold
            # and the worker's feedback math see the dtypes they expect)
            if np.issubdtype(arr.dtype, np.floating) or arr.dtype.name in (
                "bfloat16", "float8_e4m3fn", "float8_e5m2"
            ):
                if arr.size >= self.min_size:
                    return {_LEAF: self.name, "dt": arr.dtype.name,
                            **self.encode_leaf(arr.astype(np.float32))}
            return arr  # tiny/integer leaves: not worth a codec round-trip
        return {_MARK: self.name, "tree": rec(tree)}

    def decode(self, blob: dict) -> Pytree:
        def rec(node):
            if isinstance(node, dict):
                if _LEAF in node:
                    return self.decode_leaf(node).astype(
                        _resolve_dtype(node.get("dt", "float32")),
                        copy=False,  # f32 (the common case) is a no-op
                    )
                return {k: rec(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                # preserve container types exactly: the worker's feedback
                # tree.map and the PS fold require identical treedefs
                enc = [rec(v) for v in node]
                return enc if isinstance(node, list) else tuple(enc)
            return node
        return rec(blob["tree"])


#: extended float dtype names (``ml_dtypes``'s), which the port's PS trees
#: never hold
_EXTENDED_FLOATS = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def _resolve_dtype(name: str) -> np.dtype:
    """Dtype from its wire name. Extended floats need ``ml_dtypes``, which
    the port does not use: they raise, as does any other unknown name."""
    if name in _EXTENDED_FLOATS or name.startswith("float8"):
        raise TypeError(
            f"codec leaf dtype {name!r} is an extended float: the port's "
            f"parameter server carries f32 and integer trees only")
    return np.dtype(name)


class Int8Codec(Codec):
    """Symmetric per-leaf absmax int8 (~4× smaller commits)."""

    name = "int8"

    def __init__(self, min_size: int = 16):
        self.min_size = int(min_size)

    def encode_leaf(self, arr: np.ndarray) -> dict:
        amax = float(np.max(np.abs(arr)))
        scale = amax / 127.0 if amax > 0 else 1.0
        q = np.clip(np.rint(arr / scale), -127, 127).astype(np.int8)
        return {"q": q, "s": scale}

    def decode_leaf(self, blob: dict) -> np.ndarray:
        # fused int8→f32 dequant: one pass, one allocation (bit-identical
        # to astype(float32) * scale — int8→f32 conversion is exact)
        return np.multiply(blob["q"], np.float32(blob["s"]),
                           dtype=np.float32)


class TopKCodec(Codec):
    """Magnitude top-k per leaf (values + flat indices; ~``1/frac``× smaller
    at small ``frac``). Error feedback reinjects the dropped mass later."""

    name = "topk"

    def __init__(self, frac: float = 0.05):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"frac must be in (0, 1], got {frac}")
        self.frac = float(frac)

    def encode_leaf(self, arr: np.ndarray) -> dict:
        flat = arr.reshape(-1)
        k = max(1, int(np.ceil(self.frac * flat.size)))
        idx = np.argpartition(np.abs(flat), flat.size - k)[-k:]
        idx = idx.astype(np.int64 if flat.size > 2**31 else np.int32)
        return {"v": flat[idx], "i": idx, "n": list(arr.shape)}

    def decode_leaf(self, blob: dict) -> np.ndarray:
        shape = tuple(int(d) for d in blob["n"])
        out = np.zeros(int(np.prod(shape)), np.float32)
        out[blob["i"]] = blob["v"]
        return out.reshape(shape)


_REGISTRY = {"int8": Int8Codec, "topk": TopKCodec}


def register_codec(cls: type[Codec]) -> type[Codec]:
    """Register a custom codec class under ``cls.name`` (usable as a
    decorator). The PS decodes commits by name with a fresh ``cls()``, so
    a codec's ``decode_leaf`` must not depend on constructor configuration
    (the built-ins obey this: top-k's ``frac`` only shapes *encoding*) —
    and the registration must run in the PS owner's process too when the
    server is external (nothing but the name crosses the wire)."""
    if not (isinstance(cls, type) and issubclass(cls, Codec)):
        raise TypeError(f"register_codec expects a Codec subclass, got {cls}")
    _REGISTRY[cls.name] = cls
    return cls


def resolve_codec(compression) -> Codec | None:
    """Trainer kwarg → codec: ``None``, a registered name, or a Codec
    instance (auto-registered by name so the in-process PS can decode;
    external PS processes must :func:`register_codec` themselves)."""
    if compression is None:
        return None
    if isinstance(compression, Codec):
        cls = type(compression)
        reg = _REGISTRY.get(cls.name)
        if reg is None:
            try:
                cls()  # the PS decodes with a fresh cls() — fail HERE,
            except TypeError as e:  # not mid-training in a handler thread
                raise ValueError(
                    f"codec class {cls.__name__} must be constructible "
                    f"with no arguments for PS-side decode (got: {e}); "
                    f"give constructor params defaults that leave decode "
                    f"semantics unchanged"
                ) from e
            _REGISTRY[cls.name] = cls
        elif reg is not cls:
            raise ValueError(
                f"codec name {cls.name!r} is already registered to "
                f"{reg.__name__}; give your codec a unique `name` (decode "
                f"dispatches by name on the PS side)"
            )
        return compression
    if isinstance(compression, str):
        if compression in _REGISTRY:
            return _REGISTRY[compression]()
        raise ValueError(
            f"unknown compression {compression!r}; expected "
            f"{sorted(_REGISTRY)} or a Codec instance"
        )
    raise TypeError(f"compression must be None, str, or Codec, "
                    f"got {type(compression)}")


def validate_pull_compression(value):
    """Shared validator for the ``pull_compression`` knob (trainer kwarg
    and every PS client constructor): only the int8 block/leaf scheme has
    a server-side error-feedback implementation today. Returns the value.
    """
    if value not in (None, "int8"):
        raise ValueError(
            f"pull_compression must be None or 'int8', got {value!r}"
        )
    return value


def is_encoded(payload) -> bool:
    return isinstance(payload, dict) and _MARK in payload


def maybe_decode(payload: Pytree) -> Pytree:
    """PS-side seam: decode an encoded commit, pass a raw tree through."""
    if not is_encoded(payload):
        return payload
    name = payload[_MARK]
    if name not in _REGISTRY:
        raise ValueError(f"commit encoded with unknown codec {name!r}")
    codec = _REGISTRY[name]()
    return codec.decode(payload)

"""Iteration-level continuous batching over the block-paged KV cache.

Port of ``distkeras_tpu/serving/scheduler.py`` (Orca, Yu et al. OSDI '22):
batch at the granularity of one decode iteration. Each
:meth:`GenerationEngine.step`

- **admits** — strictly FIFO by default (the head of the queue is never
  skipped) whenever a batch row and enough pool blocks for the request's
  whole budget ``ceil((Lp + max_new) / block_size)`` are free, so an
  admitted request never runs out of blocks mid-flight;
- **prefills** the admitted requests in one batched ``prefill_raw`` per
  block-padded length (row count bucketed to powers of two; dummy rows
  write the scratch block) and scatters their K/V into the rows' blocks;
- **decodes** every in-flight row in one fixed-shape paged step, each row
  at its own position with its own sampling parameters, the pools updated
  in place;
- **retires** rows on EOS, budget exhaustion or cancellation, freeing
  their blocks at once.

The front door (``prefix_cache=``, ``prefill_chunk=``, ``admission="slo"``;
:mod:`~distkeras_tpu_torch.serving.frontdoor`) routes every prefill
through one chunk program, ``TransformerLM.paged_extend_rows``: suffix
prefill past a cached prefix (a radix tree over full blocks, with
copy-on-write of a partially shared block), Sarathi-style chunked prefill
of a long prompt interleaved with decode, and the recompute of a request
preempted for a higher SLO class. ``swap_params`` stages a new weight set
that lands only at the top of a step, on the scheduler thread: one decode
step never sees two weight sets, and the radix tree is flushed with it.

Speculative serving (``draft=``, ``spec_tokens``): a draft model with its
own paged cache over the same block tables proposes ``spec_tokens`` greedy
tokens a row with K+1 paged decode steps, the target verifies them in one
``paged_extend_rows`` over ``[tok, proposals]``, and each row advances by
its own accepted length plus one. Greedy only, and not beside the front
door.

The host reads the device once per program: the sampled tokens of the
chunk program and of the decode step, as the JAX engine's ``device_get``.
"""

from __future__ import annotations

import itertools
import math
import threading
import time
from collections import deque

import numpy as np
import torch

from distkeras_tpu_torch.models.lm import TransformerLM
from distkeras_tpu_torch.observability import trace as _trace
from distkeras_tpu_torch.networking import ServerBusyError
from distkeras_tpu_torch.serving.frontdoor import (
    RadixPrefixCache,
    TenantQueues,
    slo_priority,
)
from distkeras_tpu_torch.serving.paged_cache import (
    BlockAllocator,
    PagedKVCache,
    sample_rows,
    slot_map,
)
from distkeras_tpu_torch.utils import resolve_device

_req_ids = itertools.count()


def _scatter(cache: PagedKVCache, kvs, slots) -> None:
    """Write a prefill's per-block ``(k, v)`` into ``cache``'s pools at the
    flat ``slots``, in place."""
    for kp, vp, (k, v) in zip(cache.k_pools, cache.v_pools, kvs):
        kp.index_copy_(0, slots, k.reshape(-1, *kp.shape[1:]))
        vp.index_copy_(0, slots, v.reshape(-1, *vp.shape[1:]))


def per_row_new_token_counts(new_tokens, eos_id: int | None):
    """Real tokens per row of a ``[B, T]`` generated block: everything up to
    and including the first ``eos_id`` (all ``T`` when none appears)."""
    new_tokens = np.asarray(new_tokens)
    B, T = new_tokens.shape
    if eos_id is None:
        return np.full((B,), T, np.int32)
    hit = new_tokens == int(eos_id)
    first = np.argmax(hit, axis=1)
    return np.where(hit.any(axis=1), first + 1, T).astype(np.int32)


def summarize_latencies(records, window_s: float | None = None,
                        now: float | None = None) -> dict:
    """Per-SLO-class latency summary over retired-request records (dicts
    with ``t``, ``slo_class``, ``state``, ``total_s``, ``queue_s``,
    ``prefill_s``, ``decode_s``): p50/p99 end to end and mean
    queue/prefill/decode, in ms, over completed requests only (a cancelled
    request's lifetime is how long its client waited, not a served
    latency). ``window_s`` keeps the records retired within the trailing
    window ending at ``now`` (default: the newest record)."""
    recs = [r for r in records if r.get("state", "done") == "done"]
    if window_s is not None:
        t_end = now if now is not None else (
            max(r["t"] for r in recs) if recs else 0.0)
        recs = [r for r in recs if r["t"] >= t_end - window_s]
    out: dict[str, dict] = {}
    by_cls: dict[str, list] = {}
    for r in recs:
        by_cls.setdefault(r.get("slo_class", "default"), []).append(r)
    for cls, rs in sorted(by_cls.items()):
        total = np.asarray([r["total_s"] for r in rs], np.float64) * 1e3
        rec = {
            "count": len(rs),
            "p50_ms": float(np.percentile(total, 50)),
            "p99_ms": float(np.percentile(total, 99)),
        }
        for key, out_key in (("queue_s", "queue_ms"),
                             ("prefill_s", "prefill_ms"),
                             ("decode_s", "decode_ms")):
            vals = [r[key] for r in rs if r.get(key) is not None]
            if vals:
                rec[out_key] = float(np.mean(vals)) * 1e3
        out[cls] = rec
    return out


class Request:
    """One generation request moving through the engine.

    States: ``queued`` → ``running`` → ``done`` | ``cancelled`` |
    ``failed``; ``rejected`` never enters the queue. ``result()`` blocks
    on completion and returns the NEW tokens (prompt excluded) as int32.
    ``slo_class`` labels the latency telemetry and, under
    ``admission="slo"``, is the admission priority; ``tenant`` is the
    fairness bucket within a class. ``model_version`` is the engine's
    version the request was (last) admitted under."""

    def __init__(self, prompt: np.ndarray, *, max_new_tokens: int,
                 temperature: float, top_k: int | None,
                 top_p: float | None, seed: int, eos_id: int | None,
                 request_id: str | None = None,
                 slo_class: str = "default", tenant: str = "default"):
        self.id = request_id if request_id is not None \
            else f"req-{next(_req_ids)}"
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.seed = int(seed)
        self.eos_id = eos_id
        self.slo_class = str(slo_class)
        self.tenant = str(tenant)
        self.model_version: int | None = None
        self.new_tokens: list[int] = []
        self.state = "queued"
        self.error: str | None = None
        self.t_submit = time.monotonic()
        self.t_admit: float | None = None
        self.t_done: float | None = None
        self.prefill_s: float | None = None
        self._cancelled = False
        self._event = threading.Event()

    @property
    def latency_s(self) -> float | None:
        """Seconds from submission to retirement (None until retired)."""
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: float | None = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.id} still {self.state}")
        if self.state != "done":
            raise RuntimeError(
                f"request {self.id} {self.state}"
                + (f": {self.error}" if self.error else "")
            )
        return np.asarray(self.new_tokens, np.int32)


class _Slot:
    """Host bookkeeping for one occupied batch row.

    ``blocks`` are the row's PRIVATE pool blocks (freed at retire); under
    a prefix cache the row may also reference shared tree blocks through
    ``pinned`` (released, never freed, at retire). ``phase`` is
    ``"decode"`` for legacy rows; front-door rows start in ``"prefill"``
    and feed ``feed[next_pos:feed_len]`` in chunks before decoding."""

    __slots__ = ("request", "blocks", "next_pos", "last_tok",
                 "phase", "feed", "feed_len", "pinned", "cow",
                 "sample_first", "resume_tok")

    def __init__(self, request: Request, blocks: list[int]):
        self.request = request
        self.blocks = blocks
        self.next_pos = 0   # absolute position of the token being FED
        self.last_tok = 0
        self.phase = "decode"
        self.feed: np.ndarray | None = None   # tokens still to prefill
        self.feed_len = 0
        self.pinned: list = []                # pinned radix-tree nodes
        self.cow: tuple | None = None         # (node, m, dst_block)
        self.sample_first = True   # sample at prefill end (fresh request)
        self.resume_tok = 0        # pending token of a preempted request


class GenerationEngine:
    """Continuous-batching generation over a block-paged KV cache.

    ``model`` is a :class:`~distkeras_tpu_torch.models.lm.TransformerLM`
    (int8 models from ``quantize_lm`` drop in unchanged) living on
    ``device`` — the card unless the caller asks for the CPU.
    ``num_blocks`` defaults to enough for ``max_batch`` rows of ``maxlen``
    each, plus the scratch block. ``model_version`` is the version a
    serving replica advertises in its directory registration;
    :meth:`swap_params` replaces it with the weights.

    ``draft`` (a ``TransformerLM`` of the same vocab on the engine's
    device) turns on speculative serving with ``spec_tokens`` proposals a
    round; every request is then greedy, and a request's block budget and
    maxlen check count ``spec_tokens`` positions past its last token (the
    verify block probes them).

    The front door: ``prefix_cache`` shares full prompt blocks across
    requests through a radix tree; ``prefill_chunk`` feeds prompts in
    chunks of that many tokens between decode steps; ``admission="slo"``
    admits by SLO class and tenant and preempts strictly lower classes
    when the pool is short of blocks. Any of the three routes every
    prefill through the chunk program."""

    def __init__(self, model, *, max_batch: int = 8, block_size: int = 16,
                 num_blocks: int | None = None, max_queue: int = 64,
                 device="cuda", model_version: int = 0,
                 prefix_cache: bool = False,
                 prefill_chunk: int | None = None,
                 admission: str = "fifo", draft=None, spec_tokens: int = 4):
        if not isinstance(model, TransformerLM):
            raise TypeError(f"GenerationEngine needs a TransformerLM, got "
                            f"{type(model)}")
        self.device = resolve_device(device)
        if model.device.type != self.device.type or (
                self.device.index is not None
                and model.device.index != self.device.index):
            raise ValueError(f"the model lives on {model.device} but the "
                             f"engine runs on {self.device}; build the model "
                             f"with device={str(self.device)!r}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if block_size < 1 or block_size > model.maxlen:
            raise ValueError(f"block_size must be in [1, maxlen="
                             f"{model.maxlen}], got {block_size}")
        if admission not in ("fifo", "slo"):
            raise ValueError(
                f"admission must be 'fifo' or 'slo', got {admission!r}")
        if prefill_chunk is not None and int(prefill_chunk) < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self._module = model
        # the weight-swap version gate: swap_params builds the engine a
        # module of its own and stages it here; the scheduler thread puts
        # it in place of self._module only at the top of step(), under
        # the lock. The caller's module is never written, so engines that
        # share one are not swapped together
        self.model_version = int(model_version)
        self._staged_swap: tuple | None = None
        self._last_swap: dict | None = None
        self.max_batch = int(max_batch)
        self.block_size = int(block_size)
        self.max_queue = int(max_queue)
        self._nb_per_seq = math.ceil(model.maxlen / self.block_size)
        if num_blocks is None:
            num_blocks = self.max_batch * self._nb_per_seq + 1
        self.allocator = BlockAllocator(num_blocks, self.block_size)
        self.cache = PagedKVCache(model, num_blocks, self.block_size)

        self.prefix_cache = bool(prefix_cache)
        self.prefill_chunk = (None if prefill_chunk is None
                              else int(prefill_chunk))
        self.admission = str(admission)
        self._frontdoor = (self.prefix_cache
                           or self.prefill_chunk is not None
                           or self.admission == "slo")
        if self._frontdoor and draft is not None:
            raise ValueError(
                "prefix_cache/prefill_chunk/admission='slo' cannot be "
                "combined with a draft model: the draft's pools never hold "
                "a cached prefix's K/V, so speculative verify would read "
                "garbage")
        self._prefix = (RadixPrefixCache(self.block_size)
                        if self.prefix_cache else None)
        self._tq = TenantQueues() if self.admission == "slo" else None

        self._draft: TransformerLM | None = None
        self.spec_tokens = 0
        if draft is not None:
            if not isinstance(draft, TransformerLM):
                raise TypeError(f"draft must be a TransformerLM, got "
                                f"{type(draft)}")
            if draft.vocab != model.vocab:
                raise ValueError(f"draft vocab {draft.vocab} != target "
                                 f"vocab {model.vocab}")
            if int(spec_tokens) < 1:
                raise ValueError(
                    f"spec_tokens must be >= 1, got {spec_tokens}")
            if model.attn_window is not None \
                    or draft.attn_window is not None:
                raise ValueError(
                    "speculative serving does not support sliding-window "
                    "models (the verify span crosses the window band)")
            if draft.device != model.device:
                raise ValueError(f"the draft lives on {draft.device} but "
                                 f"the engine runs on {model.device}")
            self._draft = draft
            self.spec_tokens = int(spec_tokens)
            self.draft_cache = PagedKVCache(draft, num_blocks,
                                            self.block_size)

        self._tables = np.zeros((self.max_batch, self._nb_per_seq), np.int64)
        self._slots: list[_Slot | None] = [None] * self.max_batch
        # per-batch caches, rebuilt only when admission, retirement or an
        # evacuation rewrites the tables (each sets _batch_dirty), never
        # per token
        self._batch_dirty = True
        self._np_slots: np.ndarray | None = None
        self._dev_tables_by_width: dict[int, torch.Tensor] = {}
        self._sampling: tuple | None = None
        self._queue: deque[Request] = deque()
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self._stop = False
        self._thread: threading.Thread | None = None
        self.stats_ = {
            "submitted": 0, "admitted": 0, "completed": 0,
            "cancelled": 0, "rejected": 0, "failed": 0,
            "steps": 0, "prefills": 0, "tokens_generated": 0,
            "occupancy_sum": 0, "swaps": 0, "refilled": 0,
            "spec_rounds": 0, "spec_proposed": 0, "spec_accepted": 0,
        }
        if self.admission == "slo":
            self.stats_["preemptions"] = 0
        if self.prefix_cache:
            self.stats_.update(prefix_hit_tokens=0,
                               prefix_prompt_tokens=0, cow_copies=0)
        self._retired: deque = deque(maxlen=2048)

    # -- client surface ------------------------------------------------------

    def _blocks_needed(self, lp: int, max_new: int) -> int:
        return math.ceil((lp + max_new + self.spec_tokens)
                         / self.block_size)

    def submit(self, prompt, *, max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int | None = None,
               top_p: float | None = None, seed: int = 0,
               eos_id: int | None = None, request_id: str | None = None,
               slo_class: str = "default",
               tenant: str = "default") -> Request:
        """Queue one generation; returns the :class:`Request` handle at
        once. Raises :class:`ServerBusyError` when the bounded queue is
        full and ``ValueError`` on malformed requests, both before the
        queue."""
        module = self._module
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D [length], got "
                             f"{prompt.shape}")
        lp = prompt.shape[0]
        if lp < 1:
            raise ValueError("prompt must have at least one token")
        if prompt.min() < 0 or prompt.max() >= module.vocab:
            raise ValueError(f"prompt tokens outside [0, vocab="
                             f"{module.vocab})")
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if lp + max_new + self.spec_tokens > module.maxlen:
            raise ValueError(
                f"prompt length {lp} + max_new_tokens {max_new}"
                + (f" + spec_tokens {self.spec_tokens}"
                   if self.spec_tokens else "")
                + f" exceeds the model's maxlen {module.maxlen}")
        if self._blocks_needed(lp, max_new) > self.allocator.capacity:
            raise ValueError(
                f"request needs {self._blocks_needed(lp, max_new)} blocks "
                f"but the pool only has {self.allocator.capacity}")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k is not None and not 1 <= int(top_k) <= module.vocab:
            raise ValueError(f"top_k must be in [1, vocab={module.vocab}], "
                             f"got {top_k}")
        if top_p is not None and not 0.0 < float(top_p) <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if eos_id is not None and not 0 <= int(eos_id) < module.vocab:
            raise ValueError(f"eos_id {eos_id} outside vocab {module.vocab}")
        if self.spec_tokens and (temperature != 0.0 or top_k is not None
                                 or top_p is not None):
            raise ValueError(
                "speculative serving is greedy-only: temperature/top_k/"
                "top_p cannot be combined with a draft model")
        req = Request(
            prompt, max_new_tokens=max_new, temperature=float(temperature),
            top_k=top_k, top_p=top_p, seed=int(seed),
            eos_id=None if eos_id is None else int(eos_id),
            request_id=request_id, slo_class=slo_class, tenant=tenant,
        )
        with self._wake:
            if self._closed:
                raise ServerBusyError("engine is draining: not accepting "
                                      "new requests")
            if self._queued_count() >= self.max_queue:
                self.stats_["rejected"] += 1
                req.state = "rejected"
                raise ServerBusyError(f"admission queue full "
                                      f"({self.max_queue} waiting)")
            self.stats_["submitted"] += 1
            self._q_push(req)
            self._wake.notify_all()
        # flight recorder: the request id is the serving tier's
        # correlation id, so this enqueue mark, the queued and prefill
        # spans and the final serve.request span stitch one request
        # across threads
        _trace.instant("serve.enqueue", corr=req.id)
        return req

    def cancel(self, request: Request) -> None:
        """Mark a request for cancellation; the engine frees its row and
        blocks at the next iteration (queued requests never start)."""
        with self._wake:
            request._cancelled = True
            self._wake.notify_all()

    # -- queue plumbing: one strict-FIFO deque, or the tenant queues ---------

    def _queued_count(self) -> int:
        return len(self._tq) if self._tq is not None else len(self._queue)

    def _q_push(self, req: Request) -> None:
        if self._tq is not None:
            self._tq.push(req)
        else:
            self._queue.append(req)

    def _q_push_front(self, req: Request) -> None:
        if self._tq is not None:
            self._tq.push_front(req)
        else:
            self._queue.appendleft(req)

    def _q_pop_head(self, req: Request) -> None:
        if self._tq is not None:
            self._tq.pop(req)
        else:
            self._queue.popleft()

    def _q_drain(self) -> list[Request]:
        if self._tq is not None:
            return self._tq.drain()
        out = list(self._queue)
        self._queue.clear()
        return out

    # -- the weight-swap version gate ----------------------------------------

    @property
    def model(self) -> TransformerLM:
        """The module the engine serves now: the one it was built with
        until a swap lands, then the module the swap built."""
        return self._module

    @property
    def draft(self) -> TransformerLM | None:
        """The draft module the engine speculates with now (None without
        speculative serving)."""
        return self._draft

    def _module_from(self, cur: TransformerLM, weights, what: str):
        """A new module of ``cur``'s config on the engine's device, loaded
        from the state dict ``weights``, whose names and shapes must be
        exactly ``cur``'s, else ``ValueError``."""
        dest = cur.state_dict()
        names = set(weights)
        if names != set(dest):
            raise ValueError(
                f"{what} do not match the engine's model: missing "
                f"{sorted(set(dest) - names)}, unknown "
                f"{sorted(names - set(dest))}")
        weights = {name: torch.as_tensor(t) for name, t in weights.items()}
        for name, t in weights.items():
            if tuple(t.shape) != tuple(dest[name].shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != the "
                                 f"model's {tuple(dest[name].shape)}")
        del dest
        staged = TransformerLM(**cur.config, device=self.device)
        with torch.no_grad():
            staged.load_state_dict(weights)
        staged.train(cur.training)
        return staged

    def swap_params(self, weights, version: int, policy: str = "drain",
                    draft_weights=None) -> None:
        """Stage a weight swap; the scheduler applies it between steps,
        never inside one. ``weights`` is a state dict in the port's layout
        (``convert.tensors_from_jax`` or another model's ``state_dict()``)
        with exactly the engine model's names and shapes, else
        ``ValueError``. A new module of the model's config is built on the
        engine's device from them here; the module the engine was given
        is never written (another engine may serve it).

        ``policy``: ``"drain"`` pauses admission until the batch finishes
        on the old weights, then swaps; ``"refill"`` swaps at the next
        step, re-queueing every in-flight row at the head in admission
        order with its blocks freed and its tokens reset, so it is served
        again under the new weights (sampling is deterministic per seed
        and position: the stream equals a fresh run at the new version).
        ``version`` need not increase (a rollback re-stages the old one);
        staging again replaces a swap not yet applied. ``stats()
        ["last_swap"]`` records the swap once it lands.

        ``draft_weights`` (a speculative engine only) is the draft's state
        dict, built into a draft module of the engine's own in the same
        way and landed with the target's; without it the draft stays."""
        if policy not in ("drain", "refill"):
            raise ValueError(
                f"policy must be 'drain' or 'refill', got {policy!r}")
        if draft_weights is not None and self._draft is None:
            raise ValueError("draft_weights given to an engine without a "
                             "draft model")
        staged = self._module_from(self._module, weights, "weights")
        staged_draft = (None if draft_weights is None else self._module_from(
            self._draft, draft_weights, "draft_weights"))
        with self._wake:
            self._staged_swap = (staged, int(version), policy, staged_draft)
            self._wake.notify_all()

    def _apply_swap_locked(self) -> None:
        """Apply a staged swap if its policy allows (under the lock, from
        the scheduler thread only) and record it in ``_last_swap``."""
        staged = self._staged_swap
        if staged is None:
            return
        module, version, policy, draft = staged
        active = [b for b, s in enumerate(self._slots) if s is not None]
        if policy == "drain" and active:
            return  # admission is paused; the batch drains first
        if policy == "refill" and active:
            # re-queue at the front in admission order, blocks freed and
            # tokens reset: the re-prefill under the new weights replays
            rows = sorted(active,
                          key=lambda b: self._slots[b].request.t_admit,
                          reverse=True)
            for b in rows:
                self._evacuate_row(b, reset_tokens=True)
                self.stats_["refilled"] += 1
        freed = []
        if self._prefix is not None:
            # every cached block holds K/V of the OLD weights; no node is
            # pinned here (drain waited for an empty batch, refill just
            # evacuated every row)
            freed = self._prefix.flush()
            if freed:
                self.allocator.free(freed)
        self._module = module
        if draft is not None:
            self._draft = draft
        self.model_version = version
        self._staged_swap = None
        self.stats_["swaps"] += 1
        _trace.instant("serve.swap", cat="deploy",
                       args={"version": version, "policy": policy})
        self._last_swap = {
            "version": version, "policy": policy,
            "refilled": len(active),   # a drain lands on an empty batch
            "blocks_flushed": len(freed),
            "prefix_cached_blocks": (len(self._prefix)
                                     if self._prefix is not None else None),
            "blocks_in_use": self.allocator.used_blocks,
            "queued": self._queued_count(),
        }

    # -- the scheduler loop --------------------------------------------------

    def _finalize(self, req: Request, state: str,
                  error: str | None = None) -> None:
        req.state = state
        req.error = error
        req.t_done = time.monotonic()
        key = {"done": "completed", "cancelled": "cancelled",
               "failed": "failed"}[state]
        self.stats_[key] += 1
        if state == "done":
            self.stats_["tokens_generated"] += len(req.new_tokens)
        queue_s = (req.t_admit - req.t_submit
                   if req.t_admit is not None else None)
        total_s = req.t_done - req.t_submit
        decode_s = None
        if queue_s is not None:
            decode_s = total_s - queue_s - (req.prefill_s or 0.0)
        self._retired.append({
            "t": req.t_done, "slo_class": req.slo_class, "state": state,
            "total_s": total_s, "queue_s": queue_s,
            "prefill_s": req.prefill_s, "decode_s": decode_s,
            "new_tokens": len(req.new_tokens),
        })
        if _trace.enabled():
            # the whole lifetime (submit → retire); time.monotonic and the
            # tracer's perf_counter share CLOCK_MONOTONIC on Linux
            _trace.record("serve.request", int(req.t_submit * 1e9),
                          int(req.t_done * 1e9), corr=req.id,
                          args={"state": state,
                                "new_tokens": len(req.new_tokens)})
        req._event.set()

    def _retire(self, b: int, state: str, error: str | None = None) -> None:
        with self._wake:  # RLock: safe from inside step()'s locked region
            slot = self._slots[b]
            self._slots[b] = None
            self._tables[b, :] = 0
            self._batch_dirty = True
            self._release_pins(slot)
            self.allocator.free(slot.blocks)
            self._finalize(slot.request, state, error)

    def _release_pins(self, slot: _Slot) -> None:
        """Drop the row's references on shared radix-tree nodes: its
        matched chain and, if its copy-on-write has not landed yet, the
        COW source (pinned at admission so eviction cannot free it
        before the copy)."""
        if self._prefix is None:
            return
        if slot.pinned:
            self._prefix.release(slot.pinned)
            slot.pinned = []
        if slot.cow is not None:
            self._prefix.release([slot.cow[0]])
            slot.cow = None

    def _evacuate_row(self, b: int, *, reset_tokens: bool) -> None:
        """Tear one running row down and re-queue its request at the head:
        private blocks freed, tree pins released, the request ``queued``
        again. A ``refill`` swap also resets the emitted stream (it
        replays under the new weights); preemption keeps ``new_tokens``
        and re-admission re-prefills prompt + generated so far, so the
        stream resumes as if the request had never left the batch."""
        slot = self._slots[b]
        self._slots[b] = None
        self._tables[b, :] = 0
        self._batch_dirty = True
        self._release_pins(slot)
        self.allocator.free(slot.blocks)
        req = slot.request
        if reset_tokens:
            req.new_tokens = []
        req.state = "queued"
        req.t_admit = None
        req.prefill_s = None
        req.model_version = None
        self._q_push_front(req)

    def _swap_holds_door(self) -> bool:
        return (self._staged_swap is not None
                and self._staged_swap[2] == "drain")

    def _admit(self) -> list[tuple[int, Request]]:
        """FIFO admission under the lock; returns newly filled (row, req)
        pairs whose prefill still has to run (outside the lock)."""
        admitted = []
        if self._swap_holds_door():
            return admitted  # draining toward a staged swap
        free_rows = [b for b, s in enumerate(self._slots) if s is None]
        while self._queue and free_rows:
            head = self._queue[0]
            if head._cancelled:
                self._queue.popleft()
                self._finalize(head, "cancelled", "cancelled while queued")
                continue
            need = self._blocks_needed(head.prompt.shape[0],
                                       head.max_new_tokens)
            if not self.allocator.can_alloc(need):
                break       # strict FIFO: never skip the head (starvation)
            self._queue.popleft()
            b = free_rows.pop(0)
            blocks = self.allocator.alloc(need)
            self._slots[b] = _Slot(head, blocks)
            self._tables[b, :] = 0
            self._tables[b, :need] = blocks
            self._batch_dirty = True
            head.state = "running"
            head.t_admit = time.monotonic()
            head.model_version = self.model_version
            self.stats_["admitted"] += 1
            if _trace.enabled():
                # the admission wait, submit → admit
                _trace.record("serve.queued", int(head.t_submit * 1e9),
                              int(head.t_admit * 1e9), corr=head.id)
            admitted.append((b, head))
        return admitted

    # -- front-door admission ------------------------------------------------

    def _admit_frontdoor(self) -> int:
        """Admission with the front door on: the head candidate (highest
        SLO class, tenant round-robin within it) is matched against the
        prefix cache, reserved only its UNCACHED blocks, and installed in
        ``"prefill"`` phase for the chunk loop. The head is never skipped:
        when it cannot fit even after tree eviction and (under SLO
        admission) preemption of strictly-lower-priority rows, admission
        stops."""
        admitted = 0
        if self._swap_holds_door():
            return admitted
        while any(s is None for s in self._slots):
            if self._tq is not None:
                head = self._tq.candidate()
            else:
                head = self._queue[0] if self._queue else None
            if head is None:
                break
            if head._cancelled:
                self._q_pop_head(head)
                self._finalize(head, "cancelled", "cancelled while queued")
                continue
            res = self._reserve_for(head)
            if res is None:
                break
            self._q_pop_head(head)
            b = next(i for i, s in enumerate(self._slots) if s is None)
            self._install_row(b, head, res)
            admitted += 1
        return admitted

    def _reserve_for(self, req: Request):
        """Reserve blocks (and a pinned prefix-cache match) for ``req``
        under the lock, or return None when the pool cannot fit it. The
        shortfall ladder: evict refcount-0 cached chains first, then
        (SLO admission only) preempt strictly-lower-priority running rows,
        latest admitted first. A valid request always fits an empty pool
        (``submit`` rejects anything over capacity), so the ladder ends."""
        bs = self.block_size
        lp = req.prompt.shape[0]
        g = len(req.new_tokens)
        if g:
            # a resumed request re-prefills the prompt and every emitted
            # token but the pending last one, whose K/V decode writes
            feed = np.concatenate(
                [req.prompt, np.asarray(req.new_tokens[:-1], np.int32)])
        else:
            feed = req.prompt
        feed_len = int(feed.shape[0])
        total = self._blocks_needed(lp, req.max_new_tokens)
        match, cached_len = None, 0
        if self._prefix is not None:
            # a fresh request keeps its last prompt token uncached (its
            # logits seed the first sample); a resumed request's pending
            # token is known, so it may match all of its feed
            cap = feed_len if g else lp - 1
            match = self._prefix.match(feed, cap)
            if match.cow_node is not None:
                match.cow_node.refs += 1  # pinned until its slots are copied
            cached_len = match.tokens(bs)
        cb = len(match.nodes) if match else 0
        need = total - cb
        while not self.allocator.can_alloc(need):
            if self._prefix is not None:
                freed = self._prefix.evict(
                    need - self.allocator.free_blocks)
                if freed:
                    self.allocator.free(freed)
                    continue
            if not self._preempt_lower(req):
                if match is not None:
                    if match.cow_node is not None:
                        self._prefix.release([match.cow_node])
                    self._prefix.release(match.nodes)
                return None
        blocks = self.allocator.alloc(need)
        return (match, blocks, feed, feed_len, cached_len, g)

    def _preempt_lower(self, req: Request) -> bool:
        """Preempt ONE running row whose request has a strictly lower SLO
        priority (latest admitted first: the least sunk prefill), freeing
        its private blocks. The victim re-queues at its tenant's head and
        recomputes prompt + generated on re-admission."""
        if self._tq is None:
            return False
        prio = slo_priority(req.slo_class)
        victims = [b for b, s in enumerate(self._slots)
                   if s is not None
                   and slo_priority(s.request.slo_class) > prio]
        if not victims:
            return False
        b = max(victims, key=lambda x: self._slots[x].request.t_admit)
        victim_id = self._slots[b].request.id
        self._evacuate_row(b, reset_tokens=False)
        self.stats_["preemptions"] += 1
        _trace.instant("serve.preempt", corr=victim_id,
                       args={"for": req.id})
        return True

    def _install_row(self, b: int, req: Request, res) -> None:
        match, blocks, feed, feed_len, cached_len, g = res
        slot = _Slot(req, blocks)
        self._tables[b, :] = 0
        cb = len(match.nodes) if match else 0
        if cb:
            self._tables[b, :cb] = match.blocks
            slot.pinned = list(match.nodes)
        self._tables[b, cb:cb + len(blocks)] = blocks
        slot.feed = np.asarray(feed, np.int32)
        slot.feed_len = feed_len
        slot.next_pos = int(cached_len)
        if match is not None and match.cow_node is not None:
            # the divergent block's first cow_len slots are copied from the
            # COW source into the row's FIRST private block before any
            # forward reads them (_apply_cows, this step)
            slot.cow = (match.cow_node, match.cow_len, blocks[0])
        if self.prefix_cache:
            self.stats_["prefix_hit_tokens"] += int(cached_len)
            self.stats_["prefix_prompt_tokens"] += feed_len
        if g:
            slot.sample_first = False
            slot.resume_tok = int(req.new_tokens[-1])
        if cached_len >= feed_len:
            # a fully cached resume: nothing left to prefill
            slot.phase = "decode"
            slot.last_tok = slot.resume_tok
            req.prefill_s = 0.0
        else:
            slot.phase = "prefill"
        self._slots[b] = slot
        self._batch_dirty = True
        req.state = "running"
        req.t_admit = time.monotonic()
        req.model_version = self.model_version
        self.stats_["admitted"] += 1
        if _trace.enabled():
            _trace.record("serve.queued", int(req.t_submit * 1e9),
                          int(req.t_admit * 1e9), corr=req.id)

    # -- device programs -----------------------------------------------------

    def _run_prefills(self, admitted) -> None:
        """One batched ``prefill_raw`` per block-padded prompt length (row
        count bucketed to a power of two; dummy rows write the scratch
        block), K/V scattered in place into the rows' blocks, the first
        token sampled from each row's last prompt position."""
        groups: dict[int, list] = {}
        for b, req in admitted:
            lp = req.prompt.shape[0]
            lpad = math.ceil(lp / self.block_size) * self.block_size
            groups.setdefault(lpad, []).append((b, req))
        vocab = self._module.vocab
        dev = self.device
        for lpad, grp in groups.items():
            n = len(grp)
            npad = 1 << (n - 1).bit_length()
            prompts = np.zeros((npad, lpad), np.int64)
            # dummy rows scatter into the scratch block (block 0) only
            row_slots = np.tile(
                np.tile(np.arange(self.block_size, dtype=np.int64),
                        lpad // self.block_size), (npad, 1))
            lp_arr = np.ones((npad,), np.int64)
            temp = np.zeros((npad,), np.float32)
            top_k = np.full((npad,), vocab, np.int64)
            top_p = np.ones((npad,), np.float32)
            greedy = np.ones((npad,), bool)
            seeds = np.zeros((npad,), np.int64)
            for i, (b, req) in enumerate(grp):
                lp = req.prompt.shape[0]
                prompts[i, :lp] = req.prompt
                row_slots[i] = slot_map(self._tables[b:b + 1],
                                        self.block_size)[0, :lpad]
                lp_arr[i] = lp
                temp[i] = req.temperature
                if req.top_k is not None:
                    top_k[i] = req.top_k
                if req.top_p is not None:
                    top_p[i] = req.top_p
                greedy[i] = req.greedy
                seeds[i] = req.seed
            t_pf = time.perf_counter_ns()
            ints = torch.from_numpy(np.concatenate(
                [prompts, row_slots, lp_arr[:, None]], axis=1)).to(dev)
            tokens_d = ints[:, :lpad]
            slots_d = ints[:, lpad:2 * lpad].reshape(-1)
            logits, kvs = self._module.prefill_raw(tokens_d)
            _scatter(self.cache, kvs, slots_d)
            if self._draft is not None:
                _, dkvs = self._draft.prefill_raw(tokens_d)
                _scatter(self.draft_cache, dkvs, slots_d)
            last = logits[torch.arange(npad, device=dev), ints[:, -1] - 1]
            tok = sample_rows(last, temp, top_k, top_p, greedy, seeds,
                              lp_arr).cpu().numpy()   # the one host sync
            t1_pf = time.perf_counter_ns()
            for _, req in grp:
                # the group forward, attributed to every request it
                # prefilled (the same interval, each with its own corr)
                req.prefill_s = (t1_pf - t_pf) / 1e9
                if _trace.enabled():
                    _trace.record("serve.prefill", t_pf, t1_pf,
                                  corr=req.id,
                                  args={"rows": n, "lpad": lpad})
            self.stats_["prefills"] += n
            for i, (b, req) in enumerate(grp):
                slot = self._slots[b]
                slot.next_pos = req.prompt.shape[0]
                slot.last_tok = int(tok[i])
                self._emit(b, [slot.last_tok])

    def _apply_cows(self) -> None:
        """Land every pending copy-on-write: copy each COW source block's
        shared leading slots into the row's first private block, then
        unpin the source. Runs before any forward of the step: the chunk
        (or a fully cached resume's decode) attends over those slots."""
        rows = [b for b, s in enumerate(self._slots)
                if s is not None and s.cow is not None]
        if not rows:
            return
        bs = self.block_size
        src, dst, pending = [], [], []
        for b in rows:
            node, m, d = self._slots[b].cow
            src.append(node.block * bs + np.arange(m, dtype=np.int64))
            dst.append(d * bs + np.arange(m, dtype=np.int64))
            pending.append((b, node))
        src = np.concatenate(src)
        dst = np.concatenate(dst)
        # padded to a power of two with scratch self-copies (slot 0 → 0),
        # as the JAX engine pads its jitted gather-scatter
        pad = (1 << (len(src) - 1).bit_length()) - len(src)
        if pad:
            src = np.concatenate([src, np.zeros(pad, np.int64)])
            dst = np.concatenate([dst, np.zeros(pad, np.int64)])
        self.cache.copy_slots(src, dst)
        with self._wake:
            for b, node in pending:
                self._slots[b].cow = None
                self._prefix.release([node])
                self.stats_["cow_copies"] += 1

    def _run_chunks(self, rows) -> None:
        """One chunk of front-door prefill for every ``"prefill"``-phase
        row: each feeds up to ``prefill_chunk`` tokens (or its whole
        remaining feed) at its own position through ONE batched
        ``paged_extend_rows``; then the step's decode runs, so a long
        prompt interleaves with in-flight decode instead of blocking it. A
        row whose feed completes flips to decode and donates its prompt's
        full blocks to the radix tree; a fresh row samples its first token
        from the last prompt position's logits at key position
        ``feed_len`` (the legacy prefill's ``lp``), a resumed row emits
        nothing (its pending token was sampled before preemption)."""
        bs = self.block_size
        vocab = self._module.vocab
        rem = max(self._slots[b].feed_len - self._slots[b].next_pos
                  for b in rows)
        Tpad = (self.prefill_chunk if self.prefill_chunk is not None
                else 1 << (rem - 1).bit_length())
        n = len(rows)
        npad = 1 << (n - 1).bit_length()
        need_pos = max(min(Tpad, self._slots[b].feed_len
                           - self._slots[b].next_pos)
                       + self._slots[b].next_pos for b in rows)
        nb = min(self._nb_per_seq,
                 2 * math.ceil(math.ceil(need_pos / bs) / 2))
        tokens = np.zeros((npad, Tpad), np.int64)
        tables = np.zeros((npad, nb), np.int64)
        # pad rows and pad positions write the scratch block's slots:
        # garbage nobody reads, as the legacy prefill's dummy rows
        write_slots = np.tile(np.arange(Tpad, dtype=np.int64) % bs,
                              (npad, 1))
        positions = np.zeros((npad,), np.int64)
        last_idx = np.zeros((npad,), np.int64)
        sample_pos = np.zeros((npad,), np.int64)
        temp = np.zeros((npad,), np.float32)
        top_k = np.full((npad,), vocab, np.int64)
        top_p = np.ones((npad,), np.float32)
        greedy = np.ones((npad,), bool)
        seeds = np.zeros((npad,), np.int64)
        t_real = []
        for i, b in enumerate(rows):
            s = self._slots[b]
            r = s.request
            t = min(Tpad, s.feed_len - s.next_pos)
            t_real.append(t)
            tokens[i, :t] = s.feed[s.next_pos: s.next_pos + t]
            tables[i] = self._tables[b, :nb]
            pos = s.next_pos + np.arange(t)
            write_slots[i, :t] = tables[i, pos // bs] * bs + pos % bs
            positions[i] = s.next_pos
            last_idx[i] = min(max(s.feed_len - 1 - s.next_pos, 0), Tpad - 1)
            sample_pos[i] = s.feed_len
            temp[i] = r.temperature
            if r.top_k is not None:
                top_k[i] = r.top_k
            if r.top_p is not None:
                top_p[i] = r.top_p
            greedy[i] = r.greedy
            seeds[i] = r.seed
        c = self.cache
        t_pf = time.perf_counter_ns()
        ints = torch.from_numpy(np.concatenate(
            [tokens, write_slots, tables, positions[:, None],
             last_idx[:, None]], axis=1)).to(self.device)
        logits, _, _ = self._module.paged_extend_rows(
            ints[:, :Tpad], c.k_pools, c.v_pools,
            ints[:, 2 * Tpad:2 * Tpad + nb], ints[:, Tpad:2 * Tpad],
            ints[:, -2], bs)
        last = logits[torch.arange(npad, device=self.device), ints[:, -1]]
        tok = sample_rows(last, temp, top_k, top_p, greedy, seeds,
                          sample_pos).cpu().numpy()   # the one host sync
        t1_pf = time.perf_counter_ns()
        with self._wake:
            for i, b in enumerate(rows):
                s = self._slots[b]
                r = s.request
                r.prefill_s = (r.prefill_s or 0.0) + (t1_pf - t_pf) / 1e9
                if _trace.enabled():
                    _trace.record("serve.prefill", t_pf, t1_pf, corr=r.id,
                                  args={"rows": len(rows),
                                        "chunk": int(t_real[i]),
                                        "pos": int(s.next_pos)})
                s.next_pos += t_real[i]
                if s.next_pos < s.feed_len:
                    continue
                s.phase = "decode"
                self.stats_["prefills"] += 1
                if self._prefix is not None:
                    # donate the prompt's full blocks to the radix tree;
                    # blocks already cached along the chain stay private
                    nfull = r.prompt.shape[0] // bs
                    if nfull:
                        new_nodes, adopted = self._prefix.insert(
                            r.prompt,
                            [int(self._tables[b, k]) for k in range(nfull)])
                        s.pinned.extend(new_nodes)
                        if adopted:
                            adset = set(adopted)
                            s.blocks = [x for x in s.blocks
                                        if x not in adset]
                if s.sample_first:
                    s.last_tok = int(tok[i])
                    self._emit(b, [s.last_tok])
                else:
                    s.last_tok = s.resume_tok

    def _emit(self, b: int, tokens: list[int]) -> None:
        """Append emitted tokens to row ``b``'s request, applying the
        retire rule (budget, then first EOS)."""
        slot = self._slots[b]
        req = slot.request
        done = False
        for t in tokens:
            req.new_tokens.append(int(t))
            if req.eos_id is not None and int(t) == req.eos_id:
                done = True
                break
            if len(req.new_tokens) >= req.max_new_tokens:
                done = True
                break
        if done:
            self._retire(b, "done")

    def step(self) -> bool:
        """One scheduler iteration: retire cancellations, apply a staged
        swap, admit, prefill (a chunk of each prefilling row under the
        front door), one batched decode step (a speculative round with a
        draft). Returns whether any work was done."""
        with self._wake:
            for b, slot in enumerate(self._slots):
                if slot is not None and slot.request._cancelled:
                    self._retire(b, "cancelled", "cancelled by client")
            self._apply_swap_locked()
            admitted = (self._admit_frontdoor() if self._frontdoor
                        else self._admit())
        worked = bool(admitted)
        with torch.inference_mode():
            if self._frontdoor:
                self._apply_cows()
                prefill_rows = [b for b, s in enumerate(self._slots)
                                if s is not None and s.phase == "prefill"]
                if prefill_rows:
                    self._run_chunks(prefill_rows)
                    worked = True
                active = [b for b, s in enumerate(self._slots)
                          if s is not None and s.phase == "decode"]
            else:
                if admitted:
                    self._run_prefills(admitted)
                active = [b for b, s in enumerate(self._slots)
                          if s is not None]
            if not active:
                return worked
            # rows in flight ride the span: the analyzer's batch occupancy
            # ("batch" kept for older readers)
            args = ({"batch": len(active), "rows": len(active)}
                    if _trace.enabled() else None)
            with _trace.span("serve.decode_step", args=args):
                if self._draft is not None:
                    self._spec_step(active)
                else:
                    self._decode_step(active)
        with self._wake:
            self.stats_["steps"] += 1
            self.stats_["occupancy_sum"] += len(active)
        return True

    def _refresh_batch_cache(self):
        """Rebuild the per-batch slot map and sampling params — only when
        the batch lineup changed."""
        if not self._batch_dirty:
            return
        B = self.max_batch
        self._np_slots = slot_map(self._tables, self.block_size)
        self._dev_tables_by_width = {}
        temp = np.zeros((B,), np.float32)
        top_k = np.full((B,), self._module.vocab, np.int64)
        top_p = np.ones((B,), np.float32)
        greedy = np.ones((B,), bool)
        seeds = np.zeros((B,), np.int64)
        for b, s in enumerate(self._slots):
            if s is None:
                continue
            r = s.request
            temp[b] = r.temperature
            if r.top_k is not None:
                top_k[b] = r.top_k
            if r.top_p is not None:
                top_p[b] = r.top_p
            greedy[b] = r.greedy
            seeds[b] = r.seed
        self._sampling = (temp, top_k, top_p, greedy, seeds)
        self._batch_dirty = False

    def _tables_for(self, need_pos: int):
        """Device block tables truncated to the working width: the paged
        gather only covers positions ``< need_pos`` — the longest active
        row, not ``maxlen`` — bucketed to 2-block multiples."""
        nb = min(self._nb_per_seq,
                 2 * math.ceil(math.ceil(need_pos / self.block_size) / 2))
        if nb not in self._dev_tables_by_width:
            self._dev_tables_by_width[nb] = torch.from_numpy(
                np.ascontiguousarray(self._tables[:, :nb])).to(self.device)
        return self._dev_tables_by_width[nb]

    def _tok_positions(self, active):
        B = self.max_batch
        tok = np.zeros((B,), np.int64)
        positions = np.zeros((B,), np.int64)
        for b in active:
            s = self._slots[b]
            tok[b] = s.last_tok
            positions[b] = s.next_pos
        return tok, positions

    def _decode_step(self, active) -> None:
        self._refresh_batch_cache()
        B = self.max_batch
        tok, positions = self._tok_positions(active)
        write_slot = self._np_slots[np.arange(B), positions]
        if self._frontdoor:
            # rows mid-prefill sit in the batch with real (possibly shared,
            # cached) blocks in their tables at position 0: park every
            # non-decode row's write in the scratch block
            mask = np.zeros((B,), bool)
            mask[active] = True
            write_slot = np.where(mask, write_slot,
                                  np.arange(B) % self.block_size)
        dev_tables = self._tables_for(int(positions.max()) + 1)
        ints = torch.from_numpy(np.stack([tok, write_slot, positions])) \
            .to(self.device)
        c = self.cache
        logits, _, _ = self._module.paged_decode_step(
            ints[0], c.k_pools, c.v_pools, dev_tables, ints[1], ints[2],
            self.block_size)
        temp, top_k, top_p, greedy, seeds = self._sampling
        nxt = sample_rows(logits, temp, top_k, top_p, greedy, seeds,
                          positions + 1).cpu().numpy()  # the one host sync
        for b in active:
            slot = self._slots[b]
            slot.next_pos += 1
            slot.last_tok = int(nxt[b])
            self._emit(b, [slot.last_tok])

    def _spec_step(self, active) -> None:
        """One speculative round for every active row: K+1 greedy draft
        steps (the extra one writes the last proposal's K/V: without it a
        fully accepted round leaves a hole in the draft's cache at
        position p+K, which the target's verify does write, and acceptance
        erodes), one target ``paged_extend_rows`` over ``[tok,
        proposals]``, then each row emits its accepted proposals and the
        target's token after them and advances by that many."""
        K = self.spec_tokens
        self._refresh_batch_cache()
        tok, positions = self._tok_positions(active)
        idx = positions[:, None] + np.arange(K + 1)[None, :]
        write_slots = np.take_along_axis(self._np_slots, idx, axis=1)
        dev_tables = self._tables_for(int(positions.max()) + K + 1)
        ints = torch.from_numpy(np.concatenate(
            [tok[:, None], positions[:, None], write_slots], axis=1)) \
            .to(self.device)
        tok_d, pos_d, slots_d = ints[:, 0], ints[:, 1], ints[:, 2:]
        dc, c, bs = self.draft_cache, self.cache, self.block_size
        t, props = tok_d, []
        for i in range(K + 1):
            lg, _, _ = self._draft.paged_decode_step(
                t, dc.k_pools, dc.v_pools, dev_tables, slots_d[:, i],
                pos_d + i, bs)
            t = torch.argmax(lg, dim=-1)
            props.append(t)
        props = torch.stack(props[:K], dim=1)                # [B, K]
        t_logits, _, _ = self._module.paged_extend_rows(
            torch.cat([tok_d[:, None], props], dim=1), c.k_pools, c.v_pools,
            dev_tables, slots_d, pos_d, bs)
        g = torch.argmax(t_logits, dim=-1)                   # [B, K+1]
        match = (props == g[:, :K]).to(torch.int64)
        a_row = torch.cumprod(match, dim=1).sum(dim=1)
        host = torch.cat([props, g, a_row[:, None]], dim=1) \
            .cpu().numpy()                                   # the one sync
        props, g, a_row = host[:, :K], host[:, K:2 * K + 1], host[:, -1]
        with self._wake:
            self.stats_["spec_rounds"] += 1
            self.stats_["spec_proposed"] += K * len(active)
            self.stats_["spec_accepted"] += int(a_row[active].sum())
        for b in active:
            slot = self._slots[b]
            a = int(a_row[b])
            # each row advances by its own accepted length, whatever the
            # rest of the batch accepted
            slot.next_pos += a + 1
            slot.last_tok = int(g[b, a])
            self._emit(b, [int(x) for x in props[b, :a]] + [slot.last_tok])

    # -- lifecycle -----------------------------------------------------------

    def _idle(self) -> bool:
        return (self._queued_count() == 0
                and all(s is None for s in self._slots))

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        """Synchronous drive (tests, parity oracles): step until every
        queued and running request has retired."""
        for _ in range(max_steps):
            with self._lock:
                if self._idle():
                    return
            self.step()
        raise RuntimeError(f"no progress after {max_steps} steps")

    def run(self) -> None:
        while True:
            with self._wake:
                if self._stop:
                    return
                if self._idle() and self._staged_swap is None:
                    # a swap staged on an idle engine still needs one
                    # step() to land
                    self._wake.wait(0.05)
                    continue
            try:
                self.step()
            except Exception as e:  # a poisoned step must not hang clients
                with self._wake:
                    self._closed = True
                    for b, slot in enumerate(self._slots):
                        if slot is not None:
                            self._retire(b, "failed", repr(e))
                    for req in self._q_drain():
                        self._finalize(req, "failed", repr(e))
                raise

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop accepting new requests; in-flight and queued requests keep
        running to completion."""
        with self._wake:
            self._closed = True
            self._wake.notify_all()

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait until every accepted request has retired."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._idle():
                    return True
            time.sleep(0.005)
        return False

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        self.close()
        if drain and self._thread is not None:
            self.drain(timeout)
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        if self._thread is not None:
            # join before retiring leftovers: a step in flight reads the
            # rows outside the lock
            self._thread.join(timeout=10)
            self._thread = None
        with self._wake:
            for b, slot in enumerate(self._slots):
                if slot is not None:
                    self._retire(b, "cancelled", "engine stopped")
            for req in self._q_drain():
                self._finalize(req, "cancelled", "engine stopped")

    def latency_stats(self, window_s: float | None = None) -> dict:
        """Per-SLO-class latency summary (:func:`summarize_latencies`) of
        the retired-request ring, over the trailing ``window_s``."""
        with self._lock:
            recs = list(self._retired)
        return summarize_latencies(recs, window_s=window_s)

    def stats(self) -> dict:
        with self._lock:
            s = dict(self.stats_)
            retired = list(self._retired)
            s["queued"] = self._queued_count()
            s["active"] = sum(1 for x in self._slots if x is not None)
            s["model_version"] = self.model_version
            s["staged_version"] = (self._staged_swap[1]
                                   if self._staged_swap else None)
            s["last_swap"] = (dict(self._last_swap)
                              if self._last_swap else None)
            s["blocks_in_use"] = self.allocator.used_blocks
            s["blocks_free"] = self.allocator.free_blocks
            s["blocks_high_water"] = self.allocator.high_water
            if self.spec_tokens:
                s["spec_acceptance"] = (
                    round(s["spec_accepted"] / s["spec_proposed"], 4)
                    if s["spec_proposed"] else 0.0)
            s["mean_batch_occupancy"] = (
                round(s["occupancy_sum"] / s["steps"], 3)
                if s["steps"] else 0.0
            )
            if self._prefix is not None:
                s["prefix_cached_blocks"] = len(self._prefix)
                s["prefix_evictions"] = self._prefix.evictions
                tot = s["prefix_prompt_tokens"]
                s["prefix_hit_rate"] = (
                    round(s["prefix_hit_tokens"] / tot, 4) if tot else 0.0)
        s["latency"] = summarize_latencies(retired)
        return s

    def prefix_hit_rate(self) -> float:
        """Lifetime token-level prefix-cache hit rate (0.0 with the cache
        off or before any admission): what a replica publishes into its
        directory meta, the router's affinity weight."""
        with self._lock:
            if self._prefix is None:
                return 0.0
            tot = self.stats_["prefix_prompt_tokens"]
            if not tot:
                return 0.0
            return round(self.stats_["prefix_hit_tokens"] / tot, 4)

    def flush_prefix_cache(self) -> int:
        """Drop every unpinned cached chain, returning its blocks to the
        allocator; returns how many blocks were freed. Chains pinned by
        in-flight rows survive."""
        with self._lock:
            if self._prefix is None:
                return 0
            freed = self._prefix.flush()
            if freed:
                self.allocator.free(freed)
            return len(freed)

"""Iteration-level continuous batching over the block-paged KV cache.

Port of ``distkeras_tpu/serving/scheduler.py`` on its FIFO path (Orca, Yu
et al. OSDI '22): batch at the granularity of one decode iteration. Each
:meth:`GenerationEngine.step`

- **admits** strictly FIFO — the head of the queue is never skipped —
  whenever a batch row and enough pool blocks for the request's whole
  budget ``ceil((Lp + max_new) / block_size)`` are free, so an admitted
  request never runs out of blocks mid-flight;
- **prefills** the admitted requests in one batched ``prefill_raw`` per
  block-padded length (row count bucketed to powers of two; dummy rows
  write the scratch block) and scatters their K/V into the rows' blocks;
- **decodes** every in-flight row in one fixed-shape paged step, each row
  at its own position with its own sampling parameters, the pools updated
  in place;
- **retires** rows on EOS, budget exhaustion or cancellation, freeing
  their blocks at once.

The host reads the device once per step (the sampled tokens), as the JAX
engine's one ``device_get``.
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
from distkeras_tpu_torch.networking import ServerBusyError
from distkeras_tpu_torch.serving.paged_cache import (
    BlockAllocator,
    PagedKVCache,
    sample_rows,
    slot_map,
)
from distkeras_tpu_torch.utils import resolve_device

_req_ids = itertools.count()


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


def summarize_latencies(records) -> dict:
    """Per-SLO-class latency summary over retired-request records (dicts
    with ``slo_class``, ``state``, ``total_s``, ``queue_s``, ``prefill_s``,
    ``decode_s``): p50/p99 end to end and mean queue/prefill/decode, in
    ms, over completed requests only (a cancelled request's lifetime is
    how long its client waited, not a served latency)."""
    recs = [r for r in records if r.get("state", "done") == "done"]
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
    on completion and returns the NEW tokens (prompt excluded) as int32."""

    def __init__(self, prompt: np.ndarray, *, max_new_tokens: int,
                 temperature: float, top_k: int | None,
                 top_p: float | None, seed: int, eos_id: int | None,
                 request_id: str | None = None,
                 slo_class: str = "default"):
        self.id = request_id if request_id is not None \
            else f"req-{next(_req_ids)}"
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.seed = int(seed)
        self.eos_id = eos_id
        self.slo_class = str(slo_class)  # latency-telemetry label
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
    """Host bookkeeping for one occupied batch row."""

    __slots__ = ("request", "blocks", "next_pos", "last_tok")

    def __init__(self, request: Request, blocks: list[int]):
        self.request = request
        self.blocks = blocks
        self.next_pos = 0   # absolute position of the token being FED
        self.last_tok = 0


class GenerationEngine:
    """Continuous-batching generation over a block-paged KV cache.

    ``model`` is a :class:`~distkeras_tpu_torch.models.lm.TransformerLM`
    (int8 models from ``quantize_lm`` drop in unchanged) living on
    ``device`` — the card unless the caller asks for the CPU.
    ``num_blocks`` defaults to enough for ``max_batch`` rows of ``maxlen``
    each, plus the scratch block. ``model_version`` is the version a
    serving replica advertises in its directory registration (0 by
    default, as in the JAX package); nothing here changes it until the
    live weight swap (``ROADMAP.md`` A11.2) is ported."""

    def __init__(self, model, *, max_batch: int = 8, block_size: int = 16,
                 num_blocks: int | None = None, max_queue: int = 64,
                 device="cuda", model_version: int = 0):
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
        self._module = model
        self.model_version = int(model_version)
        self.max_batch = int(max_batch)
        self.block_size = int(block_size)
        self.max_queue = int(max_queue)
        self._nb_per_seq = math.ceil(model.maxlen / self.block_size)
        if num_blocks is None:
            num_blocks = self.max_batch * self._nb_per_seq + 1
        self.allocator = BlockAllocator(num_blocks, self.block_size)
        self.cache = PagedKVCache(model, num_blocks, self.block_size)

        self._tables = np.zeros((self.max_batch, self._nb_per_seq), np.int64)
        self._slots: list[_Slot | None] = [None] * self.max_batch
        # per-batch caches, rebuilt only when admission/retirement changes
        # the lineup, never per token
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
            "occupancy_sum": 0,
        }
        self._retired: deque = deque(maxlen=2048)

    # -- client surface ------------------------------------------------------

    def _blocks_needed(self, lp: int, max_new: int) -> int:
        return math.ceil((lp + max_new) / self.block_size)

    def submit(self, prompt, *, max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int | None = None,
               top_p: float | None = None, seed: int = 0,
               eos_id: int | None = None, request_id: str | None = None,
               slo_class: str = "default") -> Request:
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
        if lp + max_new > module.maxlen:
            raise ValueError(f"prompt length {lp} + max_new_tokens {max_new} "
                             f"exceeds the model's maxlen {module.maxlen}")
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
        req = Request(
            prompt, max_new_tokens=max_new, temperature=float(temperature),
            top_k=top_k, top_p=top_p, seed=int(seed),
            eos_id=None if eos_id is None else int(eos_id),
            request_id=request_id, slo_class=slo_class,
        )
        with self._wake:
            if self._closed:
                raise ServerBusyError("engine is draining: not accepting "
                                      "new requests")
            if len(self._queue) >= self.max_queue:
                self.stats_["rejected"] += 1
                req.state = "rejected"
                raise ServerBusyError(f"admission queue full "
                                      f"({self.max_queue} waiting)")
            self.stats_["submitted"] += 1
            self._queue.append(req)
            self._wake.notify_all()
        return req

    def cancel(self, request: Request) -> None:
        """Mark a request for cancellation; the engine frees its row and
        blocks at the next iteration (queued requests never start)."""
        with self._wake:
            request._cancelled = True
            self._wake.notify_all()

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
        req._event.set()

    def _retire(self, b: int, state: str, error: str | None = None) -> None:
        with self._wake:  # RLock: safe from inside step()'s locked region
            slot = self._slots[b]
            self._slots[b] = None
            self._tables[b, :] = 0
            self._batch_dirty = True
            self.allocator.free(slot.blocks)
            self._finalize(slot.request, state, error)

    def _admit(self) -> list[tuple[int, Request]]:
        """FIFO admission under the lock; returns newly filled (row, req)
        pairs whose prefill still has to run (outside the lock)."""
        admitted = []
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
            self.stats_["admitted"] += 1
            admitted.append((b, head))
        return admitted

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
            c = self.cache
            for kp, vp, (k, v) in zip(c.k_pools, c.v_pools, kvs):
                kp.index_copy_(0, slots_d, k.reshape(-1, *kp.shape[1:]))
                vp.index_copy_(0, slots_d, v.reshape(-1, *vp.shape[1:]))
            last = logits[torch.arange(npad, device=dev), ints[:, -1] - 1]
            tok = sample_rows(last, temp, top_k, top_p, greedy, seeds,
                              lp_arr).cpu().numpy()   # the one host sync
            t1_pf = time.perf_counter_ns()
            for _, req in grp:
                req.prefill_s = (t1_pf - t_pf) / 1e9
            self.stats_["prefills"] += n
            for i, (b, req) in enumerate(grp):
                slot = self._slots[b]
                slot.next_pos = req.prompt.shape[0]
                slot.last_tok = int(tok[i])
                self._emit(b, [slot.last_tok])

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
        """One scheduler iteration: retire cancellations, admit + prefill,
        one batched decode step. Returns whether any work was done."""
        with self._wake:
            for b, slot in enumerate(self._slots):
                if slot is not None and slot.request._cancelled:
                    self._retire(b, "cancelled", "cancelled by client")
            admitted = self._admit()
        with torch.inference_mode():
            if admitted:
                self._run_prefills(admitted)
            active = [b for b, s in enumerate(self._slots) if s is not None]
            if not active:
                return bool(admitted)
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

    def _decode_step(self, active) -> None:
        self._refresh_batch_cache()
        B = self.max_batch
        tok = np.zeros((B,), np.int64)
        positions = np.zeros((B,), np.int64)
        for b in active:
            s = self._slots[b]
            tok[b] = s.last_tok
            positions[b] = s.next_pos
        write_slot = self._np_slots[np.arange(B), positions]
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

    # -- lifecycle -----------------------------------------------------------

    def _idle(self) -> bool:
        return not self._queue and all(s is None for s in self._slots)

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
                if self._idle():
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
                    while self._queue:
                        self._finalize(self._queue.popleft(), "failed",
                                       repr(e))
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
            while self._queue:
                self._finalize(self._queue.popleft(), "cancelled",
                               "engine stopped")

    def prefix_hit_rate(self) -> float:
        """The token-level prefix-cache hit rate a replica publishes into
        its directory meta (the router's affinity weight). The port has no
        prefix cache until ``ROADMAP.md`` A11.1, so this is 0.0, exactly
        what the JAX engine returns with its cache off."""
        return 0.0

    def stats(self) -> dict:
        with self._lock:
            s = dict(self.stats_)
            retired = list(self._retired)
            s["queued"] = len(self._queue)
            s["active"] = sum(1 for x in self._slots if x is not None)
            s["blocks_in_use"] = self.allocator.used_blocks
            s["blocks_free"] = self.allocator.free_blocks
            s["blocks_high_water"] = self.allocator.high_water
            s["mean_batch_occupancy"] = (
                round(s["occupancy_sum"] / s["steps"], 3)
                if s["steps"] else 0.0
            )
        s["latency"] = summarize_latencies(retired)
        return s

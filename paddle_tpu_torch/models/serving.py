"""Continuous batching over the paged KV pool: the serving scheduler.

Counterpart of ``ContinuousBatchingEngine`` in
``paddle_tpu/models/serving.py`` :274, serial scheduler. Requests of mixed
lengths are admitted into fixed SLOTS of a shared page pool; decode runs
in SEGMENTS of single-token steps over all slots at per-slot depths; slots
retire and readmit between segments. The JAX engine compiles each of these
as one fixed-shape program; the port runs them eagerly, one forward per
step, and keeps the same semantics:

* pools ``(n_pages, page_size, KVH, D)`` per layer: ``max_slots * max_len /
  page_size`` real pages, then scratch pages, the last of them the DUMP
  page; page-table rows carry trailing scratch columns; row ``max_slots``
  is the scratch row that padding rows of an admission group write;
  ``attn_pages`` caps what attention reads;
* admission is FIFO, bounded by free slots and free pages (a queue head
  the pool cannot serve defers the whole queue);
* prefill runs per prompt bucket, admission groups padded to a power-of-two
  width, and samples each row's first token at its true last position;
* a decode segment is ``segment`` steps over all ``max_slots`` rows:
  frozen slots re-emit their token and do not advance, a slot deactivates
  at its length budget and at EOS, idle slots sit at length 1 on dump-page
  rows;
* pages grow lazily, page by page, before each segment;
* the fused decode path is decided once, at construction: with
  ``decode_megakernel=1`` (the JAX ``FLAGS_decode_megakernel`` default)
  and a model that passes ``megakernel_model_supported``, every decode
  step runs each layer's attention half as one fused kernel launch
  (``ops/cuda/decode_megakernel.py``); ``decode_megakernel=0`` keeps the
  unfused layers. On the CPU the fused path runs the fused plain version.

Sampling draws from per-request streams (:func:`.generation.stream_seed`
of engine seed, request id and token index), so a request's tokens do not
depend on how it was batched.

Not ported yet: chunked prefill, the prefix cache with resume and
copy-on-write, preemption, the one-deep pipeline, deadlines and abort,
poison bisection, telemetry, AOT warmup, KV page export and import.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from ..ops.cuda.decode_megakernel import (
    megakernel_model_supported,
    megakernel_scope,
)
from .generation import _make_paged_cache, _sample_rows, stream_seed
from .kv_pool import PagePool

__all__ = ["ContinuousBatchingEngine", "Request"]


class Request:
    """One generation request inside the scheduler. ``status`` goes from
    ``pending`` to ``ok``; ``tokens`` accumulates the generated ids."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "tokens", "status")

    def __init__(self, rid, prompt, max_new_tokens):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.tokens: list[int] = []
        self.status = "pending"

    def output(self):
        return np.asarray(self.tokens[:self.max_new_tokens], np.int32)

    def __repr__(self):
        return (f"Request(rid={self.rid}, len={self.prompt.size}, "
                f"status={self.status!r})")


def _bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


class ContinuousBatchingEngine:
    """Mixed-length generation over ``max_slots`` concurrent sequences on
    the model's device.

    Usage::

        eng = ContinuousBatchingEngine(model, max_slots=8, max_len=512)
        outs, stats = eng.run(prompts, max_new_tokens=64, segment=32)

    ``decode_megakernel``: 0 keeps the unfused decode layers; 1 (auto)
    takes the fused decode kernel when the model passes the probe.
    ``stats()["megakernel"]`` reports the decision.
    """

    # The fused decode kernel adds the residual and the post-attention norm
    # right after o_proj. A subclass whose o_proj output is a partial sum
    # (a tensor-parallel shard needs a reduction before the residual) must
    # opt out.
    _megakernel_ok = True

    def __init__(self, model, max_slots, max_len, page_size=128,
                 do_sample=False, temperature=1.0, top_k=None, top_p=None,
                 eos_token_id=None, prompt_buckets=(16, 32, 64, 128),
                 seed=0, decode_megakernel=1):
        model.eval()
        cfg = model.config
        self.model = model
        self.device = model.device
        self.max_slots = int(max_slots)
        page_size = min(page_size, max_len)
        max_len = -(-max_len // page_size) * page_size
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.do_sample = bool(do_sample)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_token_id = eos_token_id
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self._seed = int(seed)
        per_seq = self.max_len // self.page_size
        self._cols = per_seq  # attention-visible table columns
        # scratch pages absorb the padding rows of an admission group
        # (they write at most one bucket of tokens from base 0)
        chunk_w = self.prompt_buckets[-1]
        scratch_np = max(chunk_w // self.page_size, 1)
        n_real = self.max_slots * per_seq
        self._pool_pages = n_real
        n_pages = n_real + scratch_np
        total_cols = per_seq + -(-chunk_w // self.page_size)
        self._nl = cfg.num_hidden_layers
        shape = (n_pages, self.page_size, cfg.num_key_value_heads,
                 cfg.head_dim)
        self._ks = [torch.zeros(shape, dtype=model.dtype, device=self.device)
                    for _ in range(self._nl)]
        self._vs = [torch.zeros_like(k) for k in self._ks]
        # a table cell not backed by a granted page aliases the DUMP page
        # (the last scratch page): writes there are garbage by
        # construction and attention never reads them
        self._dump_page = n_pages - 1
        self._tables_np = np.full((self.max_slots + 1, total_cols),
                                  self._dump_page, np.int32)
        self._tables_np[self.max_slots] = n_real + np.minimum(
            np.arange(total_cols, dtype=np.int32), scratch_np - 1)
        self._tables_dev = None
        self._megakernel = (int(decode_megakernel) > 0
                            and type(self)._megakernel_ok
                            and megakernel_model_supported(model))
        self.start()

    # --------------------------------------------------- page-table state

    def _set_table_row(self, slot):
        """Mirror the slot's granted pages into its table row; the tail
        columns alias the dump page."""
        row = self._tables_np[slot]
        pages = self._slot_pages[slot]
        row[:len(pages)] = pages
        row[len(pages):] = self._dump_page
        self._tables_dev = None

    def _tables_device(self):
        """Device copy of the slot rows, uploaded again after a grant."""
        if self._tables_dev is None:
            self._tables_dev = torch.tensor(
                self._tables_np[:self.max_slots], device=self.device)
        return self._tables_dev

    def _free_slot_pages(self, slot):
        pages, self._slot_pages[slot] = self._slot_pages[slot], []
        if pages:
            self._pool.recycle(self._pool.decref(pages))
            self._set_table_row(slot)

    def _caches(self, tables, length):
        return [_make_paged_cache(self._ks[i], self._vs[i], tables,
                                  self.page_size, length,
                                  attn_pages=self._cols,
                                  dump_page=self._dump_page)
                for i in range(self._nl)]

    def _group_width(self, n):
        """Smallest power of two >= n, capped at ``max_slots``: the
        admission batch width (the JAX engine's compiled prefill shape)."""
        w = 1
        while w < n:
            w <<= 1
        return min(w, self.max_slots)

    # ----------------------------------------------------------- sampling

    def _sample(self, logits, reqs, offset):
        """Token per row of ``logits``; row i belongs to ``reqs[i]`` (None
        for idle rows) and draws stream index ``len(tokens) + offset``."""
        seeds = None
        if self.do_sample:
            seeds = [0 if r is None else stream_seed(
                self._seed, r.rid, len(r.tokens) + offset) for r in reqs]
        return _sample_rows(logits, seeds, self.temperature, self.top_k,
                            self.top_p, not self.do_sample)

    # ----------------------------------------------------------- scheduler

    def _validate(self, prompt, max_new_tokens):
        """Reject a request that could write outside its slot's pages,
        before any work is dispatched for it."""
        chunk_w = self.prompt_buckets[-1]
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds slot capacity {self.max_len}")
        if prompt.size > chunk_w:
            raise NotImplementedError(
                f"prompt of {prompt.size} tokens exceeds the largest bucket "
                f"{chunk_w}: chunked prefill is not ported yet")
        b = _bucket(prompt.size, self.prompt_buckets)
        if b > self.max_len:
            raise ValueError(
                f"prompt bucket {b} (for a {prompt.size}-token prompt) "
                f"exceeds slot capacity {self.max_len}; add a smaller bucket "
                f"or raise max_len")

    def start(self, segment=16):
        """Reset the scheduler for a new session; ``segment`` is the number
        of decode steps per ``step()``."""
        self._segment_len = int(segment)
        self._queue: deque[Request] = deque()
        self._slot_req: list[Request | None] = [None] * self.max_slots
        self._pool = PagePool(self._pool_pages)
        self._slot_pages: list[list] = [[] for _ in range(self.max_slots)]
        self._tables_np[:self.max_slots] = self._dump_page
        self._tables_dev = None
        self._lengths = np.ones((self.max_slots,), np.int32)  # idle: len 1
        self._cur_tok = np.zeros((self.max_slots,), np.int64)
        # final length a slot's last needed emission reaches
        self._limits = np.full((self.max_slots,), self.max_len, np.int32)
        self._useful = 0
        self._seg_runs = 0
        self._occ_sum = 0.0
        self._occ_n = 0
        self._auto_rid = 0
        self._t0 = time.monotonic()
        return self

    def submit(self, prompt, max_new_tokens, rid=None):
        """Enqueue one request; raises if it can never fit a slot."""
        prompt = np.asarray(prompt).astype(np.int32).ravel()
        self._validate(prompt, max_new_tokens)
        if rid is None:
            rid = self._auto_rid
            self._auto_rid += 1
        elif isinstance(rid, int) and rid >= self._auto_rid:
            self._auto_rid = rid + 1
        req = Request(rid, prompt, max_new_tokens)
        self._queue.append(req)
        return req

    def has_work(self) -> bool:
        return bool(self._queue) or any(
            r is not None for r in self._slot_req)

    def _retire(self, req, finished, slot):
        self._slot_req[slot] = None
        self._lengths[slot] = 1  # the slot returns to the idle pool
        self._free_slot_pages(slot)
        req.status = "ok"
        finished.append(req)

    def _finish_admit(self, slot, req, tok, finished):
        """Post-prefill bookkeeping: seat the request, count its first
        token, set the slot's length budget, retire at once on EOS or an
        exhausted budget."""
        self._slot_req[slot] = req
        req.tokens.append(int(tok))
        self._useful += 1
        self._lengths[slot] = req.prompt.size
        self._cur_tok[slot] = int(tok)
        self._limits[slot] = (req.prompt.size + req.max_new_tokens
                              - len(req.tokens))
        if len(req.tokens) >= req.max_new_tokens or (
                self.eos_token_id is not None
                and req.tokens[-1] == self.eos_token_id):
            self._retire(req, finished, slot)

    @torch.no_grad()
    def _dispatch_prefill(self, group, bucket, finished):
        """One prefill over a same-bucket admission group padded to its
        width; padding rows write the scratch row's pages."""
        g = self._group_width(len(group))
        padded = np.zeros((g, bucket), np.int64)
        true_lens = np.ones((g,), np.int64)
        rows = np.full((g,), self.max_slots, np.int64)
        for i, (slot, req) in enumerate(group):
            padded[i, :req.prompt.size] = req.prompt
            true_lens[i] = req.prompt.size
            rows[i] = slot
        dev = self.device
        tables = torch.tensor(self._tables_np[rows], device=dev)
        with megakernel_scope(False):
            logits = self.model(torch.tensor(padded, device=dev),
                                caches=self._caches(tables, 0))
        n = len(group)
        last = logits[torch.arange(n, device=dev),
                      torch.tensor(true_lens[:n] - 1, device=dev)]
        tok0 = self._sample(last, [req for _, req in group], 0).cpu().numpy()
        for i, (slot, req) in enumerate(group):
            self._finish_admit(slot, req, tok0[i], finished)

    @torch.no_grad()
    def _segment_round(self, mask, finished):
        """One decode segment over all slots (``mask`` marks the live
        ones), then the host bookkeeping: append emissions, retire."""
        dev = self.device
        tables = self._tables_device()
        limits = torch.tensor(self._limits, device=dev)
        tok = torch.tensor(self._cur_tok, device=dev)
        lengths = torch.tensor(self._lengths, device=dev)
        active = torch.tensor(mask, device=dev)
        emitted, was_active = [], []
        with megakernel_scope(self._megakernel):
            for i in range(self._segment_len):
                logits = self.model(tok[:, None],
                                    caches=self._caches(tables, lengths))
                nxt = self._sample(logits[:, -1], self._slot_req, i)
                nxt = torch.where(active, nxt, tok)  # frozen slots re-emit
                new_lengths = torch.where(active, lengths + 1, lengths)
                # deactivate at the per-slot budget: a slot never advances
                # past its validated capacity mid-segment
                new_active = active & (new_lengths < limits)
                if self.eos_token_id is not None:
                    new_active = new_active & (nxt != self.eos_token_id)
                emitted.append(nxt)
                was_active.append(active)
                tok, lengths, active = nxt, new_lengths, new_active
        self._seg_runs += 1
        emitted = torch.stack(emitted).cpu().numpy()
        was_active = torch.stack(was_active).cpu().numpy()
        still_active = active.cpu().numpy()
        self._lengths = lengths.cpu().numpy()
        self._cur_tok = tok.cpu().numpy()
        for slot in np.flatnonzero(mask):
            req = self._slot_req[slot]
            toks = req.tokens
            for s in range(self._segment_len):
                if not was_active[s, slot] or len(toks) >= req.max_new_tokens:
                    break
                toks.append(int(emitted[s, slot]))
                self._useful += 1
            if (len(toks) >= req.max_new_tokens
                    or (self.eos_token_id is not None and toks
                        and toks[-1] == self.eos_token_id)
                    or not still_active[slot]):
                self._retire(req, finished, slot)

    def _plan_admission(self, req):
        """Pages covering ``req``'s prompt, or None when the pool cannot
        cover the prompt plus its first segment of decode growth."""
        P = int(req.prompt.size)
        page = self.page_size
        total = -(-P // page)
        final_len = max(P + req.max_new_tokens - 1, P)
        want = min(P + self._segment_len, final_len)
        if self._pool.available() < max(-(-want // page), total):
            return None
        return self._pool.alloc(total)

    def _ensure_pages(self):
        """Grant every live slot the pages its next segment can write. The
        pool holds a full-length sequence per slot, so this always fits;
        preemption under a smaller pool is not ported."""
        need = []
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            tgt = min(int(self._lengths[slot]) + self._segment_len,
                      int(self._limits[slot]))
            short = -(-tgt // self.page_size) - len(self._slot_pages[slot])
            if short > 0:
                need.append((slot, short))
        if sum(n for _, n in need) > self._pool.available():
            raise RuntimeError("KV page pool exhausted during decode "
                               "(preemption is not ported)")
        for slot, n in need:
            self._slot_pages[slot].extend(self._pool.alloc(n))
            self._set_table_row(slot)

    def step(self):
        """One scheduler turn: admit queued requests into free slots (one
        prefill per prompt bucket), grow pages, run one decode segment.
        Returns the requests that finished in this turn."""
        finished: list[Request] = []
        free = [s for s in range(self.max_slots) if self._slot_req[s] is None]
        admitting = []
        while self._queue and len(admitting) < len(free):
            req = self._queue[0]
            pages = self._plan_admission(req)
            if pages is None:  # the pool is short: the whole queue defers
                break
            self._queue.popleft()
            slot = free[len(admitting)]
            self._slot_pages[slot] = pages
            self._set_table_row(slot)
            admitting.append((slot, req))
        by_bucket: dict[int, list] = {}
        for slot, req in admitting:
            by_bucket.setdefault(_bucket(req.prompt.size, self.prompt_buckets),
                                 []).append((slot, req))
        for bucket, grp in by_bucket.items():
            self._dispatch_prefill(grp, bucket, finished)
        self._ensure_pages()
        mask = np.array([r is not None for r in self._slot_req])
        if mask.any():
            self._occ_sum += float(mask.mean())
            self._occ_n += 1
            self._segment_round(mask, finished)
        return finished

    def stats(self):
        """Session stats; ``tokens_per_sec`` is useful tokens over the
        session's wall time (0.0 for an empty session); ``megakernel``
        says whether decode steps take the fused kernel."""
        dt = time.monotonic() - self._t0
        return {
            "tokens_per_sec": (self._useful / dt
                               if dt > 0 and self._useful else 0.0),
            "useful_tokens": self._useful,
            "mean_occupancy": (self._occ_sum / self._occ_n
                               if self._occ_n else 0.0),
            "segments": self._seg_runs,
            "wall_s": dt,
            "megakernel": self._megakernel,
        }

    def run(self, prompts, max_new_tokens, segment=16):
        """Generate ``max_new_tokens`` for every prompt (1-D int arrays of
        mixed lengths). Returns (outputs, stats): ``outputs[i]`` is the
        generated ids of ``prompts[i]``."""
        prompts_np = [np.asarray(p).astype(np.int32).ravel() for p in prompts]
        for p in prompts_np:
            self._validate(p, max_new_tokens)
        self.start(segment=segment)
        reqs = [self.submit(p, max_new_tokens, rid=i)
                for i, p in enumerate(prompts_np)]
        while self.has_work():
            self.step()
        stats = self.stats()
        stats["statuses"] = [r.status for r in reqs]
        return [r.output() for r in reqs], stats

"""Continuous batching over the paged KV pool: the serving scheduler.

Counterpart of ``ContinuousBatchingEngine`` in
``paddle_tpu/models/serving.py`` :274, with its default scheduler, the
one-deep pipeline (``_pipelined_round`` :1662). Requests of mixed
lengths are admitted into fixed SLOTS of a shared page pool; decode runs
in SEGMENTS of single-token steps over all slots at per-slot depths; slots
retire and readmit between segments. The JAX engine compiles each of these
as one fixed-shape program. The port runs admission eagerly and each
decode segment, on the card, as one replay of a CUDA graph captured once
per engine and segment length (JAX's compiled ``segment`` :617); on the
CPU the same segment runs eagerly. The semantics are JAX's:

* pools ``(n_pages, page_size, KVH, D)`` per layer: ``pool_pages``
  allocatable pages (default one full-length sequence per slot), then
  scratch pages, the last of them the DUMP page; page-table rows carry
  trailing scratch columns (a padded tail written past ``max_len`` lands
  there); row ``max_slots`` is the scratch row that padding rows of an
  admission group write; ``attn_pages`` caps what attention reads;
* the pool is DYNAMIC (``models/kv_pool.py``): a slot is granted pages for
  its prompt at admission and grows page by page before each segment;
  retirement returns them. Admission is FIFO, bounded by free slots and
  free pages: a queue head the pool cannot serve defers the whole queue
  (``serving.kv_pool_exhausted``). When decode growth outruns the pool,
  prefix-cache leaves are evicted, then the youngest slot is PREEMPTED
  back to the queue's front (``serving.kv_preempted``) with its emitted
  tokens folded into its prompt, and resumes with the same stream;
* prompt prefixes are shared through a :class:`.kv_pool.PrefixCache`: a
  new request maps the cached full pages read-only and prefills only from
  the first divergent token (a RESUME at a per-row base); a match ending
  mid-page copies the covering page first (copy-on-write);
* prompts up to the largest bucket prefill in one padded forward per
  bucket (admission groups padded to a power-of-two width); longer
  prompts take CHUNKED PREFILL: full largest-bucket chunks at per-row
  bases, rows past their chunks on the scratch row, then one padded final
  chunk that samples the first token at the true last position; a
  request's deadline is checked between chunks;
* a decode segment is ``segment`` steps over all ``max_slots`` rows:
  frozen slots re-emit their token and do not advance, a slot deactivates
  at its length budget and at EOS, idle slots sit at length 1 on dump-page
  rows; deadlines retire requests between segments;
* the PIPELINE (the default; ``pipeline=False`` is the serial scheduler):
  segment N+1 is dispatched from segment N's device outputs (its final
  tokens, lengths and active mask stay in the graph's buffers) while the
  host does segment N's bookkeeping. Host-only changes of the mask
  (admission, abort, a deadline, preemption) drain the pipeline first;
  growth covers two segments (``_growth_horizon``). On the CPU "in
  flight" means computed and not yet consumed: the same code decides;
* the fused decode path is decided once, at construction: with
  ``decode_megakernel=1`` (the JAX ``FLAGS_decode_megakernel`` default)
  and a model that passes ``megakernel_model_supported``, every decode
  step runs each layer's attention half as one fused kernel launch
  (``ops/cuda/decode_megakernel.py``); ``decode_megakernel=0`` keeps the
  unfused layers. On the CPU the fused path runs the fused plain version.

Sampling draws from per-request streams (:func:`.generation.stream_seed`
of engine seed, request id and token index ``token_base + emitted``), so
a request's tokens do not depend on how it was batched, chunked,
preempted or speculated. A captured segment cannot seed generators: its
uniform noise is drawn before each replay, on the engine's stream, by the
same helper that the eager sampler uses.

JAX's free-page quarantine (``_mark_dispatch``/``_mark_executed``/
``_recycle`` :448-473) has no counterpart here. Under the pipeline a page
freed on the host may still be written by a segment in flight (an aborted
slot stays active in it; a frozen slot rewrites its own cell). It is safe
to grant again at once, because every device write and read of a page
(prefill, chunk, copy, graph replay, noise fill, table upload) runs on the
engine's one stream in program order: a new owner's writes come after the
stale segment's, and an owner reads only positions it wrote itself (or
cached prompt pages, which no segment writes: decode writes lie past the
prompt).

Not ported yet: poison bisection (a launch failure propagates), telemetry,
capture of the prefill, chunk, resume and copy dispatches (they run
eagerly), KV page export and import, and the ``trace``/``tenant``/
``hold_kv``/``kv_import`` request fields.
"""
from __future__ import annotations

import contextlib
import logging
import time
import zlib
from collections import Counter, deque

import numpy as np
import torch

from ..core.resilience import Deadline, bump_counter
from ..ops.cuda import _build
from ..ops.cuda.decode_megakernel import (
    megakernel_model_supported,
    megakernel_scope,
)
from .generation import (
    _fill_noise,
    _make_paged_cache,
    _sample_rows,
    _sample_with_noise,
    stream_seed,
)
from .kv_pool import PagePool, PrefixCache

__all__ = ["ContinuousBatchingEngine", "Request"]

logger = logging.getLogger("paddle_tpu_torch.serving")


class Request:
    """One generation request inside the scheduler. ``status`` goes from
    ``pending`` to ``ok``, ``timed_out`` or ``cancelled``; ``tokens``
    accumulates the generated ids.

    ``token_base`` is the offset of the request's sampling stream: a
    failover resume submits the original prompt plus the ``k`` tokens
    already emitted elsewhere with ``token_base=k``, so the first token
    sampled here is stream index ``k``. ``preempted`` is set when the
    engine pulled the request off its slot to free pages; its emitted
    tokens are then part of ``prompt`` (the first ``folded`` of them), and
    re-admission needs pages for its whole remaining budget."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "deadline", "tokens",
                 "status", "token_base", "preempted", "folded")

    def __init__(self, rid, prompt, max_new_tokens, deadline=None,
                 token_base=0):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.deadline = deadline or Deadline.never()
        self.tokens: list[int] = []
        self.status = "pending"
        self.token_base = int(token_base)
        self.preempted = False
        self.folded = 0

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


def _stream_id(rid) -> int:
    """The sampling stream of a request id: the id itself when it is an
    integer, else the CRC32 of its text (as the JAX engine's)."""
    try:
        return int(rid) & 0xFFFFFFFFFFFFFFFF
    except (TypeError, ValueError):
        return zlib.crc32(str(rid).encode())


class _DecodeSegment:
    """One segment length's decode program over the engine's static
    buffers: ``out`` (2 * seg + 3, max_slots) int64 receives the emitted
    tokens, the was-active mask and the final tokens, lengths and mask;
    ``noise`` (seg, max_slots, vocab) f32 the sampled engine's uniform
    draws; ``graph`` its CUDA graph (None where it runs eagerly) and
    ``launches`` the kernel launches one replay makes; ``host`` two host
    copies of ``out`` used in turn (pinned on the card, each with the
    event of its copy), so that a dispatch never overwrites outputs that
    the host has not read yet."""

    __slots__ = ("seg", "out", "noise", "graph", "launches", "host",
                 "events", "turn")

    def __init__(self, seg, slots, vocab, device, do_sample):
        self.seg = seg
        self.out = torch.zeros((2 * seg + 3, slots), dtype=torch.int64,
                               device=device)
        self.noise = (torch.zeros((seg, slots, vocab), dtype=torch.float32,
                                  device=device) if do_sample else None)
        self.graph = None
        self.launches = Counter()
        cuda = device.type == "cuda"
        self.host = [torch.zeros(self.out.shape, dtype=torch.int64,
                                 pin_memory=cuda) for _ in range(2)]
        self.events = [torch.cuda.Event() if cuda else None
                       for _ in range(2)]
        self.turn = 0


class ContinuousBatchingEngine:
    """Mixed-length generation over ``max_slots`` concurrent sequences on
    the model's device.

    Usage::

        eng = ContinuousBatchingEngine(model, max_slots=8, max_len=512)
        eng.warmup(segment=32)   # optional: capture the decode segment
        outs, stats = eng.run(prompts, max_new_tokens=64, segment=32)

    ``pool_pages`` sizes the shared page pool (default: one full-length
    sequence per slot; fewer than one raises). ``prefix_cache`` shares
    prompt prefixes copy-on-write. ``pipeline``: None (the default) or
    True runs the one-deep pipeline, as JAX's engine does under
    ``FLAGS_serving_pipeline``'s default (the port has no flag registry);
    False the serial scheduler (dispatch, wait, consume, one segment at a
    time). Prompts past the largest bucket take chunked prefill, which
    needs ``max_len`` to be a multiple of the largest bucket.

    ``decode_megakernel``: 0 keeps the unfused decode layers; 1 (auto)
    takes the fused decode kernel when the model passes the probe.
    ``stats()["megakernel"]`` reports the decision.

    On a CUDA model every decode segment is one replay of a CUDA graph,
    captured at :meth:`warmup` or at the first segment of its length, on
    the engine's own stream; the graph holds the model's weights and the
    pools by address, so they must be updated in place, never replaced.
    A capture that fails raises.
    """

    # The fused decode kernel adds the residual and the post-attention norm
    # right after o_proj. A subclass whose o_proj output is a partial sum
    # (a tensor-parallel shard needs a reduction before the residual) must
    # opt out.
    _megakernel_ok = True
    # A CUDA engine replays each decode segment as a captured graph. A
    # subclass that sets this False runs the segment's launches eagerly:
    # the reference that the captured segment is measured and checked
    # against.
    _capture_decode = True

    def __init__(self, model, max_slots, max_len, page_size=128,
                 do_sample=False, temperature=1.0, top_k=None, top_p=None,
                 eos_token_id=None, prompt_buckets=(16, 32, 64, 128),
                 seed=0, pipeline=None, pool_pages=None, prefix_cache=True,
                 decode_megakernel=1):
        model.eval()
        cfg = model.config
        self.model = model
        self.device = model.device
        self.max_slots = int(max_slots)
        page_size = min(page_size, max_len)
        if max_len % page_size:
            rounded = -(-max_len // page_size) * page_size
            logger.warning(
                "ContinuousBatchingEngine: max_len %d rounded up to %d "
                "(a multiple of page_size %d); kv_stats() reports the "
                "effective value", max_len, rounded, page_size)
            self._max_len_rounded_from = int(max_len)
            max_len = rounded
        else:
            self._max_len_rounded_from = None
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.do_sample = bool(do_sample)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_token_id = eos_token_id
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self._seed = int(seed)
        self._pipeline = True if pipeline is None else bool(pipeline)
        per_seq = self.max_len // self.page_size
        self._cols = per_seq  # attention-visible table columns
        # scratch pages absorb the padding rows of an admission group
        # (they write at most one chunk of tokens from base 0)
        chunk_w = self.prompt_buckets[-1]
        scratch_np = max(chunk_w // self.page_size, 1)
        n_real = (self.max_slots * per_seq if pool_pages is None
                  else int(pool_pages))
        if n_real < per_seq:
            raise ValueError(
                f"pool_pages {n_real} cannot hold one full-length "
                f"sequence ({per_seq} pages of {self.page_size} tokens "
                f"for max_len {self.max_len})")
        self._pool_pages = n_real
        n_pages = n_real + scratch_np
        # trailing scratch columns: a resume writes a padded bucket at any
        # base, and a final chunk a padded chunk, so a padding tail may
        # spill up to chunk_w tokens past max_len onto scratch pages
        total_cols = per_seq + -(-chunk_w // self.page_size)
        self._nl = cfg.num_hidden_layers
        self._vocab = cfg.vocab_size
        # the engine's own stream: every device read and write of the
        # pools and the decode state runs on it in program order (see the
        # module docstring), and memory allocated on it is reused by its
        # work alone
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        shape = (n_pages, self.page_size, cfg.num_key_value_heads,
                 cfg.head_dim)
        with self._on_stream():
            self._ks = [torch.zeros(shape, dtype=model.dtype,
                                    device=self.device)
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
        self._use_prefix = bool(prefix_cache)
        self._kv_bytes_per_token = int(
            self._nl * 2 * cfg.num_key_value_heads * cfg.head_dim
            * self._ks[0].element_size())
        self._megakernel = (int(decode_megakernel) > 0
                            and type(self)._megakernel_ok
                            and megakernel_model_supported(model))
        # the decode segment's static device state: the slot rows of the
        # page table, each slot's last token, length, active flag and
        # length budget. A sync dispatch uploads them from the host; a
        # segment leaves its final tokens, lengths and mask in them, which
        # a speculative dispatch reads as they are
        m = self.max_slots
        with self._on_stream():
            self._d_tables = torch.full((m, total_cols), self._dump_page,
                                        dtype=torch.int32, device=self.device)
            self._d_tok = torch.zeros((m,), dtype=torch.int64,
                                      device=self.device)
            self._d_lengths = torch.ones((m,), dtype=torch.int32,
                                         device=self.device)
            self._d_active = torch.zeros((m,), dtype=torch.bool,
                                         device=self.device)
            self._d_limits = torch.full((m,), self.max_len,
                                        dtype=torch.int32, device=self.device)
        self._tables_dirty = True
        self._programs: dict[int, _DecodeSegment] = {}
        self.start()

    # --------------------------------------------------- page-table state

    def _set_table_row(self, slot):
        """Mirror the slot's granted pages into its table row; the tail
        columns alias the dump page."""
        row = self._tables_np[slot]
        pages = self._slot_pages[slot]
        row[:len(pages)] = pages
        row[len(pages):] = self._dump_page
        self._tables_dirty = True

    def _upload(self, dst, array):
        """Copy host ``array`` into the device buffer ``dst`` on the
        engine's stream without waiting for it: through a pinned copy of
        the array that the host allocator keeps until the copy ran, so
        the host may rewrite ``array`` at once."""
        src = torch.from_numpy(np.ascontiguousarray(array))
        if dst.is_cuda:
            dst.copy_(src.pin_memory(), non_blocking=True)
        else:
            dst.copy_(src)

    def _on_stream(self):
        """The engine's stream as the current one (nothing on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    @contextlib.contextmanager
    def _device_turn(self):
        """Run the enclosed engine work on the engine's stream, after the
        caller's stream's earlier work (the model's weights), and make the
        caller's stream wait for it in turn, without a host sync."""
        if self._stream is None:
            yield
            return
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            yield
        caller.wait_stream(self._stream)

    def _recycle(self, pages):
        # no quarantine: see the module docstring
        self._pool.recycle(pages)

    def _free_slot_pages(self, slot):
        """Release the slot's grants (a shared page drops one reference;
        pages the prefix cache holds survive for later hits)."""
        pages, self._slot_pages[slot] = self._slot_pages[slot], []
        if pages:
            self._recycle(self._pool.decref(pages))
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

    def _sample(self, logits, reqs):
        """Token per row of ``logits``; row i belongs to ``reqs[i]`` and
        draws stream index ``token_base + len(tokens)``."""
        seeds = None
        if self.do_sample:
            seeds = [stream_seed(self._seed, _stream_id(r.rid),
                                 r.token_base + len(r.tokens)) for r in reqs]
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
        if prompt.size <= chunk_w:
            b = _bucket(prompt.size, self.prompt_buckets)
            if b > self.max_len:
                raise ValueError(
                    f"prompt bucket {b} (for a {prompt.size}-token prompt) "
                    f"exceeds slot capacity {self.max_len}; add a smaller "
                    f"bucket or raise max_len")
        elif self.max_len % chunk_w:
            # the final chunk is padded to chunk_w: the write stays inside
            # the slot's pages when chunk_w divides the capacity
            raise ValueError(
                f"chunked prefill (prompt {prompt.size} > largest bucket "
                f"{chunk_w}) requires max_len ({self.max_len}) to be a "
                f"multiple of the largest bucket")

    def start(self, segment=16, run_deadline=None):
        """Reset the scheduler for a new session: slots, queue, pool and
        prefix cache, counters. ``segment`` is the number of decode steps
        per ``step()``; ``run_deadline`` (a ``Deadline``) bounds the whole
        session: past it, unfinished requests retire as ``timed_out``."""
        self._segment_len = int(segment)
        self._run_deadline = run_deadline or Deadline.never()
        self._queue: deque[Request] = deque()
        self._slot_req: list[Request | None] = [None] * self.max_slots
        self._pool = PagePool(self._pool_pages)
        self._prefix = (PrefixCache(self._pool, self.page_size,
                                    self._recycle)
                        if self._use_prefix else None)
        self._slot_pages: list[list] = [[] for _ in range(self.max_slots)]
        self._tables_np[:self.max_slots] = self._dump_page
        self._tables_dirty = True
        self._slot_adm = [0] * self.max_slots  # admission order per slot
        self._adm_seq = 0
        self._resume_base: dict[int, int] = {}
        self._cow_pair: dict[int, tuple] = {}
        self.admission_blocked = False  # the pool deferred the queue head
        self._prefix_lookup_tokens = 0
        self._prefix_hit_tokens = 0
        self._lengths = np.ones((self.max_slots,), np.int32)  # idle: len 1
        self._cur_tok = np.zeros((self.max_slots,), np.int64)
        # final length a slot's last needed emission reaches
        self._limits = np.full((self.max_slots,), self.max_len, np.int32)
        self._useful = 0
        self._seg_runs = 0
        self._occ_sum = 0.0
        self._occ_n = 0
        self._counts = {"ok": 0, "timed_out": 0, "failed": 0,
                        "cancelled": 0}
        self._dispatches = {"prefill": 0, "resume": 0, "chunk": 0,
                            "final_chunk": 0, "cow_pages": 0}
        self._auto_rid = 0
        # pipeline state: at most ONE dispatched, unconsumed segment;
        # ``_dirty`` marks host changes of the mask that the device cannot
        # see (abort, deadline retirement, preemption): the next turn
        # drains and dispatches from the host view
        self._inflight = None
        self._dirty = False
        # host gap: from the end of one segment's bookkeeping to the next
        # dispatch
        self._gap_sum = 0.0
        self._gap_n = 0
        self._t_host0 = None
        self._t0 = time.monotonic()
        return self

    def submit(self, prompt, max_new_tokens, deadline_s=None, rid=None,
               token_base=0):
        """Enqueue one request; raises ``ValueError`` if it can never fit
        a slot. ``deadline_s`` is a budget in seconds (or a ``Deadline``)
        from submission, so queue wait counts. ``token_base=k``: ``prompt``
        is the original prompt plus ``k`` tokens emitted elsewhere and
        ``max_new_tokens`` the remaining budget; sampling starts at stream
        index ``k``. Returns the ``Request``."""
        prompt = np.asarray(prompt).astype(np.int32).ravel()
        self._validate(prompt, max_new_tokens)
        if rid is None:
            rid = self._auto_rid
            self._auto_rid += 1
        elif isinstance(rid, int) and rid >= self._auto_rid:
            self._auto_rid = rid + 1
        deadline = (deadline_s if isinstance(deadline_s, Deadline)
                    else Deadline(deadline_s))
        req = Request(rid, prompt, max_new_tokens, deadline,
                      token_base=token_base)
        self._queue.append(req)
        return req

    def has_work(self) -> bool:
        """Queued or seated requests, or a segment still in flight (after
        the last live request is aborted mid-pipeline, one more ``step()``
        consumes it)."""
        return (bool(self._queue)
                or any(r is not None for r in self._slot_req)
                or self._inflight is not None)

    def free_slots(self) -> int:
        return sum(r is None for r in self._slot_req)

    def active_requests(self) -> list:
        return [r for r in self._slot_req if r is not None]

    def queued_requests(self) -> list:
        return list(self._queue)

    def abort(self, rid, status="cancelled"):
        """Pull a request out of the queue or its slot; its partial tokens
        stay on the handle and its pages return. Returns the ``Request``,
        or None if it is unknown or already finished."""
        for req in self._queue:
            if req.rid == rid:
                self._queue.remove(req)
                self._retire(req, status)
                return req
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.rid == rid:
                self._retire(req, status, slot=slot)
                if self._inflight is not None:
                    # the segment in flight still decodes this slot: its
                    # emissions are dropped at consume, and the next
                    # dispatch starts from the repaired host mask
                    self._dirty = True
                return req
        return None

    def _retire(self, req, status, finished=None, slot=None):
        if req.status != "pending":
            return
        if slot is not None:
            self._slot_req[slot] = None
            self._lengths[slot] = 1  # the slot returns to the idle pool
            self._free_slot_pages(slot)
        req.status = status
        self._counts[status] = self._counts.get(status, 0) + 1
        if finished is not None:
            finished.append(req)

    def _finish_admit(self, slot, req, tok, finished):
        """Post-prefill bookkeeping of the short, chunked and resume
        paths: seat the request, count its first token, set the slot's
        length budget, insert the prompt's full pages into the prefix
        cache, retire at once on EOS or an exhausted budget. A preempted
        request re-admits here with its emitted tokens in its prompt;
        ``len(tokens)`` counts them, so the stream index and the budget
        stay those of the whole request."""
        self._slot_req[slot] = req
        req.tokens.append(int(tok))
        self._useful += 1
        self._lengths[slot] = req.prompt.size
        self._cur_tok[slot] = int(tok)
        self._limits[slot] = (req.prompt.size + req.max_new_tokens
                              - len(req.tokens))
        if self._prefix is not None:
            self._prefix.insert(req.prompt, self._slot_pages[slot])
        if len(req.tokens) >= req.max_new_tokens or (
                self.eos_token_id is not None
                and req.tokens[-1] == self.eos_token_id):
            self._retire(req, "ok", finished, slot=slot)

    def _forward(self, ids, rows, base):
        """The model over ``ids`` (g, L) writing the KV of row i into the
        table row ``rows[i]`` from ``base`` (0, or per-row bases)."""
        dev = self.device
        tables = torch.tensor(self._tables_np[rows], device=dev)
        length = (base if isinstance(base, int)
                  else torch.tensor(base, dtype=torch.int32, device=dev))
        with megakernel_scope(False):
            return self.model(torch.tensor(ids, device=dev),
                              caches=self._caches(tables, length))

    def _sample_admitted(self, logits, group, true_lens, finished):
        """Sample each admitted row's first token at its true last
        position and seat it."""
        dev = self.device
        n = len(group)
        last = logits[torch.arange(n, device=dev),
                      torch.tensor(true_lens[:n] - 1, device=dev)]
        tok0 = self._sample(last, [req for _, req in group]).cpu().numpy()
        for i, (slot, req) in enumerate(group):
            self._finish_admit(slot, req, tok0[i], finished)

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
        self._dispatches["prefill"] += 1
        logits = self._forward(padded, rows, 0)
        self._sample_admitted(logits, group, true_lens, finished)

    @torch.no_grad()
    def _dispatch_resume(self, group, bucket, finished):
        """Prefix-resume admission: each row's shared prefix
        (``_resume_base`` tokens, keyed by request identity) is mapped from
        the cache; only the divergent tail, padded to ``bucket``, is
        written from that base (which may sit mid-page: the copy-on-write
        copy runs first) and the first token sampled at the true last
        position."""
        pairs = [self._cow_pair[id(req)] for _, req in group
                 if id(req) in self._cow_pair]
        if pairs:
            self._dispatch_cow(pairs)
        g = self._group_width(len(group))
        padded = np.zeros((g, bucket), np.int64)
        bases = np.zeros((g,), np.int32)
        true_lens = np.ones((g,), np.int64)
        rows = np.full((g,), self.max_slots, np.int64)
        for i, (slot, req) in enumerate(group):
            m = self._resume_base[id(req)]
            rem = req.prompt.size - m
            padded[i, :rem] = req.prompt[m:]
            bases[i] = m
            true_lens[i] = rem
            rows[i] = slot
        self._dispatches["resume"] += 1
        logits = self._forward(padded, rows, bases)
        self._sample_admitted(logits, group, true_lens, finished)

    @torch.no_grad()
    def _dispatch_cow(self, pairs):
        """Copy-on-write page copies ``(src, dst)``: ``k[dst] = k[src]``
        and the same for v in every layer, on the engine's stream, so the
        resume prefill that appends into ``dst`` runs after it."""
        dev = self.device
        src = torch.tensor([s for s, _ in pairs], dtype=torch.long,
                           device=dev)
        dst = torch.tensor([d for _, d in pairs], dtype=torch.long,
                           device=dev)
        for pool in self._ks + self._vs:
            pool[dst] = pool[src]
        self._dispatches["cow_pages"] += len(pairs)
        bump_counter("serving.kv_cow_copies", len(pairs))

    def _split_expired(self, items):
        live, expired = [], []
        for slot, req in items:
            if req.deadline.expired() or self._run_deadline.expired():
                expired.append((slot, req))
            else:
                live.append((slot, req))
        return live, expired

    @torch.no_grad()
    def _chunked_prefill(self, group, finished):
        """Chunked prefill of prompts past the largest bucket: full
        ``chunk_w``-token chunks at per-row bases (a row's first at its
        resume base, page-aligned, when the prefix cache matched), rows
        past their full chunks on the scratch row, then one padded final
        chunk that samples the first token. A request whose deadline
        expires between chunks retires ``timed_out`` with no further
        chunk dispatched."""
        chunk_w = self.prompt_buckets[-1]
        scratch = self.max_slots
        start = {id(req): self._resume_base.get(id(req), 0)
                 for _, req in group}
        n_full = {id(req): (req.prompt.size - start[id(req)] - 1) // chunk_w
                  for _, req in group}
        live = list(group)
        expired = []
        c = 0
        while live:
            live, dead = self._split_expired(live)
            expired += dead
            if not live or not any(c < n_full[id(req)] for _, req in live):
                break
            g = self._group_width(len(live))
            chunk_arr = np.zeros((g, chunk_w), np.int64)
            bases = np.zeros((g,), np.int32)
            rows = np.full((g,), scratch, np.int64)
            for i, (slot, req) in enumerate(live):
                if c < n_full[id(req)]:
                    b0 = start[id(req)] + c * chunk_w
                    chunk_arr[i] = req.prompt[b0:b0 + chunk_w]
                    bases[i] = b0
                    rows[i] = slot
            self._dispatches["chunk"] += 1
            self._forward(chunk_arr, rows, bases)
            c += 1
        if live:
            g = self._group_width(len(live))
            final_arr = np.zeros((g, chunk_w), np.int64)
            bases = np.zeros((g,), np.int32)
            true_rem = np.ones((g,), np.int64)
            rows = np.full((g,), scratch, np.int64)
            for i, (slot, req) in enumerate(live):
                done = start[id(req)] + n_full[id(req)] * chunk_w
                rem = req.prompt.size - done
                final_arr[i, :rem] = req.prompt[done:]
                bases[i] = done
                true_rem[i] = rem
                rows[i] = slot
            self._dispatches["final_chunk"] += 1
            logits = self._forward(final_arr, rows, bases)
            self._sample_admitted(logits, live, true_rem, finished)
        for slot, req in expired:
            # slot= returns the admission's grants (the request was never
            # seated)
            self._retire(req, "timed_out", finished, slot=slot)

    # ------------------------------------------------- the decode segment

    def _program(self, seg):
        """The decode program of segment length ``seg``, built at first
        use: on a CUDA engine that captures, its graph is captured now."""
        prog = self._programs.get(seg)
        if prog is None:
            prog = _DecodeSegment(seg, self.max_slots, self._vocab,
                                  self.device, self.do_sample)
            if self._stream is not None and type(self)._capture_decode:
                self._capture(prog)
            self._programs[seg] = prog
        return prog

    def _capture(self, prog):
        """Capture ``prog``'s segment as one CUDA graph on the engine's
        stream. The segment runs once eagerly first, on idle slots (every
        row on the dump page, inactive), so that the paged-decode and
        megakernel workspaces and cuBLAS's exist for this stream; the
        decode state is restored after, and the table uploaded again at
        the next dispatch. That run's launches count as launches; the
        capture's do not: they are recorded as the graph's, and each
        replay credits them to ``launch_counts``."""
        state = (self._d_tok, self._d_lengths, self._d_active,
                 self._d_limits)
        saved = [t.clone() for t in state]
        self._d_tables.fill_(self._dump_page)
        self._d_active.zero_()
        self._tables_dirty = True
        self._segment_body(prog)
        before = Counter(_build.launch_counts)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream):
            self._segment_body(prog)
        prog.launches = Counter(_build.launch_counts) - before
        _build.launch_counts.clear()
        _build.launch_counts.update(before)
        prog.graph = graph
        for t, value in zip(state, saved):
            t.copy_(value)

    @torch.no_grad()
    def _segment_body(self, prog):
        """``prog.seg`` decode steps over all slots from the static state:
        frozen slots re-emit their token and do not advance, a slot
        deactivates at its budget and at EOS. Writes ``prog.out`` and
        leaves the final tokens, lengths and mask in the state buffers.
        Nothing here syncs the host, so a CUDA graph can capture it."""
        seg = prog.seg
        tables, limits = self._d_tables, self._d_limits
        tok, lengths, active = self._d_tok, self._d_lengths, self._d_active
        emitted, was_active = [], []
        with megakernel_scope(self._megakernel):
            for i in range(seg):
                logits = self.model(tok[:, None],
                                    caches=self._caches(tables, lengths))
                last = logits[:, -1]
                if self.do_sample:
                    nxt = _sample_with_noise(last, prog.noise[i],
                                             self.temperature, self.top_k,
                                             self.top_p)
                else:
                    nxt = torch.argmax(last, dim=-1)
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
        out = prog.out
        out[:seg] = torch.stack(emitted)
        out[seg:2 * seg] = torch.stack(was_active)
        out[2 * seg] = tok
        out[2 * seg + 1] = lengths
        out[2 * seg + 2] = active
        self._d_tok.copy_(tok)
        self._d_lengths.copy_(lengths)
        self._d_active.copy_(active)

    def _stage_noise(self, prog, offset):
        """Fill ``prog.noise`` for the seated slots: step i of slot s draws
        from its request's stream at index ``token_base + len(tokens) +
        offset + i`` (``offset`` skips the emissions of a segment still
        in flight), as the eager sampler draws it."""
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            base = req.token_base + len(req.tokens) + offset
            sid = _stream_id(req.rid)
            _fill_noise(prog.noise[:, slot],
                        [stream_seed(self._seed, sid, base + i)
                         for i in range(prog.seg)])

    def _dispatch_segment(self, mask, speculative=False):
        """Dispatch one decode segment without waiting for it. A sync
        dispatch uploads the host view (tokens, lengths, ``mask``, budgets)
        first; a speculative one runs from the previous segment's final
        state, left in the buffers, and skips its emissions in the
        sampling streams. Returns the handle that :meth:`_consume` reads."""
        now = time.monotonic()
        if self._t_host0 is not None:
            self._gap_sum += now - self._t_host0
            self._gap_n += 1
            self._t_host0 = None
        seg = self._segment_len
        prog = self._program(seg)
        if self.do_sample:
            self._stage_noise(prog, seg if speculative else 0)
        if self._tables_dirty:
            self._upload(self._d_tables, self._tables_np[:self.max_slots])
            self._tables_dirty = False
        if not speculative:
            self._upload(self._d_tok, self._cur_tok)
            self._upload(self._d_lengths, self._lengths)
            self._upload(self._d_active, mask)
            self._upload(self._d_limits, self._limits)
        if prog.graph is not None:
            prog.graph.replay()
            _build.launch_counts.update(prog.launches)
        else:
            self._segment_body(prog)
        turn = prog.turn
        prog.turn ^= 1
        host, event = prog.host[turn], prog.events[turn]
        host.copy_(prog.out, non_blocking=event is not None)
        if event is not None:
            event.record(self._stream)
        self._seg_runs += 1
        return {"host": host, "event": event, "seg": seg,
                "mask": np.array(mask, dtype=bool)}

    def _consume(self, h, finished):
        """Wait for one dispatched segment's outputs and do its host
        bookkeeping: mirror lengths and tokens, append emissions, retire
        finished slots."""
        if h["event"] is not None:
            h["event"].synchronize()
        out = h["host"].numpy()
        seg = h["seg"]
        emitted, was_active = out[:seg], out[seg:2 * seg]
        still_active = out[2 * seg + 2]
        self._cur_tok = out[2 * seg].copy()
        self._lengths = out[2 * seg + 1].astype(np.int32)
        # slots freed while this segment was in flight (abort, deadline)
        # stay at the idle length: the device view still carries the dead
        # request's advance
        for slot, req in enumerate(self._slot_req):
            if req is None:
                self._lengths[slot] = 1
        for slot in np.flatnonzero(h["mask"]):
            req = self._slot_req[slot]
            if req is None:
                continue
            toks = req.tokens
            for s in range(seg):
                if not was_active[s, slot] or len(toks) >= req.max_new_tokens:
                    break
                toks.append(int(emitted[s, slot]))
                self._useful += 1
            if (len(toks) >= req.max_new_tokens
                    or (self.eos_token_id is not None and toks
                        and toks[-1] == self.eos_token_id)
                    or not still_active[slot]):
                self._retire(req, "ok", finished, slot=slot)
        self._t_host0 = time.monotonic()

    def _drain_pipeline(self, finished):
        """Consume the segment in flight, if any, so that the host view of
        slots and lengths is current: before admission, and before any
        change of the mask the device cannot see."""
        h, self._inflight = self._inflight, None
        self._dirty = False
        if h is not None:
            self._consume(h, finished)

    def _segment_round(self, mask, finished):
        """The serial turn: dispatch one segment, wait, consume."""
        if mask.any():
            self._consume(self._dispatch_segment(mask), finished)

    def _pipelined_round(self, mask, finished):
        """One overlapped turn: dispatch the next segment before consuming
        the previous one, so the device computes segment N+1 while the
        host does segment N's bookkeeping. The speculative dispatch runs
        from segment N's final state on the device: retirements the device
        decided (EOS, budget) ride its mask; host-only changes drain first
        (``step``)."""
        prev = self._inflight
        if prev is None:
            self._inflight = self._dispatch_segment(mask)
            return
        seg = self._segment_len
        # speculate only when some slot can outlive the segment in flight
        # (EOS aside): otherwise every masked slot retires when ``prev`` is
        # consumed and the speculative segment would be waste
        spec_worthy = any(
            self._slot_req[s] is not None
            and len(self._slot_req[s].tokens) + seg
            < self._slot_req[s].max_new_tokens
            for s in np.flatnonzero(mask))
        if not spec_worthy:
            self._drain_pipeline(finished)
            return
        self._inflight = self._dispatch_segment(mask, speculative=True)
        self._consume(prev, finished)

    def step(self):
        """One scheduler turn: admit queued requests into free slots (one
        prefill per prompt bucket, one resume per tail bucket, chunked
        prefill for long prompts), grow or preempt pages, run one decode
        segment (overlapped with the previous segment's bookkeeping when
        pipelined), then retire expired requests. Returns the requests
        that finished in this turn (one segment behind the device when
        pipelined)."""
        with self._device_turn():
            return self._step()

    def _step(self):
        finished: list[Request] = []
        # admission and mask repair need a current host view: consume the
        # segment in flight first (a prefill rewrites a freed slot's
        # pages; the segment in flight was built on the old mask)
        if self._inflight is not None and (
                self._dirty or (self._queue and self.free_slots() > 0)):
            self._drain_pipeline(finished)
        # admission: FIFO, bounded by free slots and free pool pages; a
        # head the pool cannot serve defers the whole queue (no skipping
        # ahead: small requests must not starve a big one)
        self.admission_blocked = False
        self._resume_base = {}
        self._cow_pair = {}
        chunk_w = self.prompt_buckets[-1]
        free = [s for s in range(self.max_slots) if self._slot_req[s] is None]
        admitting, long_adm, resume_adm = [], [], []
        fi = 0
        while self._queue and fi < len(free):
            req = self._queue[0]
            if req.status != "pending":
                self._queue.popleft()
                continue
            plan = self._plan_admission(req)
            if plan is None:
                bump_counter("serving.kv_pool_exhausted")
                self.admission_blocked = True
                break
            self._queue.popleft()
            slot = free[fi]
            fi += 1
            shared, m, cow_src, newp = plan
            self._slot_pages[slot] = list(shared) + newp
            self._set_table_row(slot)
            self._slot_adm[slot] = self._adm_seq
            self._adm_seq += 1
            self._prefix_lookup_tokens += int(req.prompt.size)
            if m:
                self._prefix_hit_tokens += m
                self._resume_base[id(req)] = m
                if cow_src is not None:
                    # the divergent page: copy the cached content into the
                    # slot's private page, then append into the copy
                    self._cow_pair[id(req)] = (
                        cow_src, self._slot_pages[slot][len(shared)])
                if req.prompt.size - m <= chunk_w:
                    resume_adm.append((slot, req))
                else:
                    long_adm.append((slot, req))
            elif req.prompt.size > chunk_w:
                long_adm.append((slot, req))
            else:
                admitting.append((slot, req))
        by_bucket: dict[int, list] = {}
        for slot, req in admitting:
            by_bucket.setdefault(_bucket(req.prompt.size, self.prompt_buckets),
                                 []).append((slot, req))
        for bucket, grp in by_bucket.items():
            self._dispatch_prefill(grp, bucket, finished)
        r_by_bucket: dict[int, list] = {}
        for slot, req in resume_adm:
            b = _bucket(req.prompt.size - self._resume_base[id(req)],
                        self.prompt_buckets)
            r_by_bucket.setdefault(b, []).append((slot, req))
        for bucket, grp in r_by_bucket.items():
            self._dispatch_resume(grp, bucket, finished)
        if long_adm:
            self._chunked_prefill(long_adm, finished)
        if self._cow_pair:
            # every copy is dispatched by now: release the plan's holds on
            # the copy sources
            self._recycle(self._pool.decref(
                [s for s, _ in self._cow_pair.values()]))
            self._cow_pair = {}
        # decode growth: every live slot holds the pages its next segment
        # can write before it runs (may preempt; a decode never fails)
        self._ensure_pages(finished)
        mask = np.array([r is not None for r in self._slot_req])
        if mask.any():
            self._occ_sum += float(mask.mean())
            self._occ_n += 1
            if self._pipeline:
                self._pipelined_round(mask, finished)
            else:
                self._segment_round(mask, finished)
        elif self._inflight is not None:
            # nothing live in the host view, a segment still in flight
            # (every slot retired at the last consume): drain it
            self._drain_pipeline(finished)
        # deadlines between segments: an expired slot retires with its
        # partial output; queued requests that expired while waiting
        # drain the same way; a run deadline retires everything left
        retired_slot = False
        for slot in range(self.max_slots):
            req = self._slot_req[slot]
            if req is not None and (req.deadline.expired()
                                    or self._run_deadline.expired()):
                self._retire(req, "timed_out", finished, slot=slot)
                retired_slot = True
        if retired_slot and self._inflight is not None:
            # the device cannot see a deadline: drain and dispatch from the
            # host view next turn
            self._dirty = True
        if self._queue:
            waiting: deque[Request] = deque()
            for req in self._queue:
                if req.status != "pending":
                    continue
                if req.deadline.expired() or self._run_deadline.expired():
                    self._retire(req, "timed_out", finished)
                else:
                    waiting.append(req)
            self._queue = waiting
        return finished

    # ------------------------------------------------ dynamic page pool

    def _growth_horizon(self) -> int:
        """Positions the next dispatch may write past a slot's host-view
        length: one segment, or two when pipelined (the segment in flight
        and the speculative one)."""
        return self._segment_len * (2 if self._pipeline else 1)

    def _plan_admission(self, req):
        """Page plan for admitting ``req``: match its prompt against the
        prefix cache, then reserve pool pages for the unshared part.
        Returns ``(shared_pages, resume_tokens, cow_src, new_pages)``,
        with the pool references taken, or None when the pool (after
        evicting cache leaves) cannot cover the prompt plus its first
        segment of growth. A preempted request needs its whole remaining
        budget, so it cannot thrash straight back out."""
        P = int(req.prompt.size)
        page = self.page_size
        chunk_w = self.prompt_buckets[-1]
        shared, m, cow_src = [], 0, None
        if self._prefix is not None and P > 1:
            pages, matched, partial = self._prefix.match(req.prompt)
            mtok = matched + (partial.r if partial is not None else 0)
            # the last token always runs through the model: its logits
            # sample the first token
            mtok = min(mtok, P - 1)
            if P - mtok > chunk_w:
                # a long tail takes the chunked path from a page boundary
                mtok = (mtok // page) * page
            full = mtok // page
            shared = pages[:full]
            m = mtok
            if m % page:
                # a mid-page resume base: the covering cached page is
                # copied, never written
                cow_src = pages[full] if full < len(pages) else partial.page
        total = -(-P // page)
        new_needed = total - len(shared)
        remaining = req.max_new_tokens - len(req.tokens)
        final_len = max(P + remaining - 1, P)
        want_tokens = (final_len if req.preempted
                       else min(P + self._growth_horizon(), final_len))
        check_needed = max(-(-want_tokens // page), total) - len(shared)
        if self._pool.available() < check_needed:
            if self._prefix is not None:
                excl = set(shared)
                if cow_src is not None:
                    excl.add(cow_src)
                self._prefix.evict(
                    check_needed - self._pool.available(), exclude=excl)
            if self._pool.available() < check_needed:
                return None
        for p in shared:
            self._pool.incref(p)
        if cow_src is not None:
            # hold the copy source until the copy has been dispatched
            self._pool.incref(cow_src)
        newp = self._pool.alloc(new_needed) if new_needed else []
        return shared, m, cow_src, newp

    def _ensure_pages(self, finished):
        """Grant every live slot the pages its next dispatch can write.
        Under pool pressure: evict prefix-cache leaves, then preempt the
        youngest slot back to the queue (draining the pipeline first),
        until the rest fit. JAX's branch that flushes its free-page
        quarantine has no counterpart (see the module docstring)."""
        horizon = self._growth_horizon()
        while True:
            need = []
            for slot, req in enumerate(self._slot_req):
                if req is None:
                    continue
                tgt = min(int(self._lengths[slot]) + horizon,
                          int(self._limits[slot]))
                short = (-(-tgt // self.page_size)
                         - len(self._slot_pages[slot]))
                if short > 0:
                    need.append((slot, short))
            total = sum(n for _, n in need)
            if not total:
                return
            if self._pool.available() < total and self._prefix is not None:
                self._prefix.evict(total - self._pool.available())
            if self._pool.available() >= total:
                for slot, n in need:
                    self._slot_pages[slot].extend(self._pool.alloc(n))
                    self._set_table_row(slot)
                return
            victims = [s for s, r in enumerate(self._slot_req)
                       if r is not None]
            if len(victims) <= 1:
                # the pool holds one full sequence and a lone slot's own
                # grants count against its need, so this cannot happen
                raise RuntimeError(
                    f"KV page pool of {self._pool_pages} pages cannot grow "
                    f"a lone slot by {total} pages")
            self._preempt(max(victims, key=lambda s: self._slot_adm[s]),
                          finished)

    def _preempt(self, slot, finished):
        """Pull the request off ``slot`` to free its pages. Its emitted
        tokens not yet in its prompt are appended to it, so its stream
        index (``token_base + len(tokens)``) and its budget are unchanged
        and its continuation is the uninterrupted one; it goes back to the
        queue's front."""
        req = self._slot_req[slot]
        bump_counter("serving.kv_preempted")
        if self._inflight is not None:
            # the segment in flight still decodes this slot: consume it
            # first (its emissions for the slot are regenerated alike
            # after re-admission)
            self._dirty = True
            self._drain_pipeline(finished)
            if self._slot_req[slot] is not req or req.status != "pending":
                return  # retired while draining: its pages are back
        if len(req.tokens) > req.folded:
            req.prompt = np.concatenate(
                [req.prompt, np.asarray(req.tokens[req.folded:], np.int32)])
            req.folded = len(req.tokens)
        req.preempted = True
        self._slot_req[slot] = None
        self._lengths[slot] = 1
        self._free_slot_pages(slot)
        self._queue.appendleft(req)

    # ----------------------------------------------------------- accounting

    def kv_stats(self) -> dict:
        """Point-in-time KV accounting of this engine: pool occupancy,
        bytes (a shared page counts once), the unused tail of the pages
        granted to live slots, and the session's prefix-cache hits."""
        active = [s for s, r in enumerate(self._slot_req) if r is not None]
        if active:
            used = int(self._lengths[active].astype(np.int64).sum())
            pages = sum(len(self._slot_pages[s]) for s in active)
            phys = len({p for s in active for p in self._slot_pages[s]})
        else:
            used = pages = phys = 0
        cap_tokens = pages * self.page_size
        lookups, hits = self._prefix_lookup_tokens, self._prefix_hit_tokens
        return {
            "bytes_in_use": phys * self.page_size * self._kv_bytes_per_token,
            "slot_occupancy": len(active) / self.max_slots,
            "fragmentation_pct": (100.0 * (1.0 - used / cap_tokens)
                                  if cap_tokens else 0.0),
            "bytes_per_token": self._kv_bytes_per_token,
            "pages_total": self._pool_pages,
            "pages_free": self._pool.available(),
            "pages_granted": phys,
            "pages_pinned_export": 0,  # KV export is not ported yet
            "prefix_cached_pages": (len(self._prefix)
                                    if self._prefix is not None else 0),
            "prefix_hit_rate": (hits / lookups) if lookups else 0.0,
            "prefix_tokens_saved": hits,
            "max_len": self.max_len,
            "max_len_rounded_from": self._max_len_rounded_from,
            "page_size": self.page_size,
        }

    def stats(self):
        """Session stats; ``tokens_per_sec`` is useful tokens over the
        session's wall time (0.0 for an empty session), so an engine not
        warmed (:meth:`warmup`) counts its first segment's capture in it;
        ``segments`` counts every dispatched segment, speculative ones
        included; ``host_gap_ms`` is the mean host time from finishing one
        segment's bookkeeping to the next dispatch (``host_gap_total_s``
        the session's total; pipelined, that work overlaps the device's);
        ``pipelined`` says which scheduler runs; ``megakernel`` whether
        decode steps take the fused kernel; ``dispatches`` counts
        prefills, resumes, chunks, final chunks and copied pages; ``kv`` is
        :meth:`kv_stats`."""
        dt = time.monotonic() - self._t0
        return {
            "tokens_per_sec": (self._useful / dt
                               if dt > 0 and self._useful else 0.0),
            "useful_tokens": self._useful,
            "mean_occupancy": (self._occ_sum / self._occ_n
                               if self._occ_n else 0.0),
            "segments": self._seg_runs,
            "wall_s": dt,
            "host_gap_ms": (1e3 * self._gap_sum / self._gap_n
                            if self._gap_n else 0.0),
            "host_gap_total_s": self._gap_sum,
            "pipelined": self._pipeline,
            "megakernel": self._megakernel,
            "timed_out": self._counts["timed_out"],
            "failed": self._counts["failed"],
            "cancelled": self._counts["cancelled"],
            "dispatches": dict(self._dispatches),
            "kv": self.kv_stats(),
        }

    def group_widths(self):
        """Every admission group width: {1, 2, 4, ..., max_slots}."""
        out = []
        w = 1
        while w < self.max_slots:
            out.append(w)
            w <<= 1
        out.append(self.max_slots)
        return tuple(out)

    def warmup(self, segment=None):
        """Build what the decode path needs before the first request: on
        the card the kernel library (built once a checkout, cached on disk
        by its sources' digest) and the CUDA graph of a decode segment of
        ``segment`` steps (default: the last ``start(segment=...)``, else
        16) for this engine's sampling mode. Later sessions with that
        segment length replay it; an engine not warmed captures at its
        first segment instead. Returns ``{"programs": graphs newly
        captured, "cached": graphs already present, "seconds": wall}``; on
        the CPU nothing is captured (programs 0).

        JAX's ``cache_dir`` (its persistent compilation cache) has no
        counterpart: the library is already cached on disk, and a CUDA
        graph does not outlive its process. The prefill, chunk, resume and
        copy dispatches run eagerly and are not captured here."""
        t0 = time.monotonic()
        seg = int(segment if segment is not None else self._segment_len)
        stats = {"programs": 0, "cached": 0}
        if self._stream is not None:
            _build.library()
            if type(self)._capture_decode:
                stats["cached" if seg in self._programs else "programs"] += 1
                with self._device_turn():
                    self._program(seg)
        stats["seconds"] = time.monotonic() - t0
        return stats

    def run(self, prompts, max_new_tokens, segment=16,
            request_deadline_s=None, timeout_s=None):
        """Generate ``max_new_tokens`` for every prompt (1-D int arrays of
        mixed lengths). Returns (outputs, stats): ``outputs[i]`` is the
        generated ids of ``prompts[i]``; ``stats["statuses"]`` each
        request's status. ``request_deadline_s`` is a budget per request
        (a scalar, or one entry per prompt; None is unbounded) from this
        call's start; ``timeout_s`` bounds the whole call. Past either,
        requests retire ``timed_out`` with the tokens they have."""
        prompts_np = [np.asarray(p).astype(np.int32).ravel() for p in prompts]
        for p in prompts_np:
            self._validate(p, max_new_tokens)
        if request_deadline_s is None or not np.iterable(request_deadline_s):
            request_deadline_s = [request_deadline_s] * len(prompts)
        if len(request_deadline_s) != len(prompts):
            raise ValueError(
                f"request_deadline_s has {len(request_deadline_s)} entries "
                f"for {len(prompts)} prompts")
        self.start(segment=segment, run_deadline=Deadline(timeout_s))
        reqs = [self.submit(p, max_new_tokens, deadline_s=s, rid=i)
                for i, (p, s) in enumerate(zip(prompts_np,
                                               request_deadline_s))]
        while self.has_work():
            self.step()
        stats = self.stats()
        stats["statuses"] = [r.status for r in reqs]
        return [r.output() for r in reqs], stats

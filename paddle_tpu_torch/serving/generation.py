"""Continuous batching for causal-LM generation over a paged KV cache
(port of ``paddle_tpu/serving/generation.py``).

- The KV cache is a fixed-size page pool per layer (``serving.paged_kv``):
  each sequence holds a page table, requests sharing a prompt prefix share
  its ref-counted pages through the prefix cache (no re-prefill), and
  admission is bounded by pool pages.
- A sequence owns a slot only while it generates; a queued prompt joins at
  the next step boundary, earliest deadline first, and requests whose
  deadline passes while queued are shed before prefill.
- Prefill and decode are one fixed-shape **window step**
  (:func:`build_window_step`): it embeds ``W`` tokens per slot, writes their
  K/V through the page tables, attends through the paged-attention kernel
  and returns the greedy argmax and its logprob at every window position.
  ``W = 1`` is decode; ``W = bucket`` prefills a prompt suffix.

Greedy decoding (``GPTForCausalLM.generate``'s argmax contract). Left for
later slices: the draft model and speculative decode, ``swap_weights``, KV
export/install, the warm host tier, fault injection and the observability
hubs.
"""
from __future__ import annotations

import itertools
import math
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from ..device import resolve_device
from ..kernels.paged_attention import paged_attention
from ..models.convert import gpt_engine_params
from .base import BadRequest, DeadlineExceeded, EngineBase
from .paged_kv import PagedKVPool, PoolExhausted, token_blocks

__all__ = ["GenerationConfig", "GenerationEngine", "build_window_step"]

_GEN_NO = itertools.count(1)

# EDF fairness bound: a request WITHOUT a deadline is ordered as if due
# this long after arrival, so sustained deadline-bearing traffic can delay
# it by at most the horizon — never starve it. Ordering only; shedding
# applies to explicit deadlines alone.
_EDF_DEFAULT_HORIZON_S = 300.0


class GenerationConfig:
    """Page pool + prompt-bucket declaration."""

    def __init__(self, max_slots: int = 4, max_seq_len: Optional[int] = None,
                 prefill_buckets: Tuple[int, ...] = (16, 32, 64, 128),
                 max_queue: int = 256, eos_token_id: Optional[int] = None,
                 page_len: int = 16, num_pages: Optional[int] = None,
                 prefix_cache: bool = True):
        self.max_slots = int(max_slots)
        self.max_seq_len = max_seq_len  # None: model max_position_embeddings
        self.prefill_buckets = tuple(sorted({int(b)
                                             for b in prefill_buckets}))
        self.max_queue = int(max_queue)
        self.eos_token_id = eos_token_id
        self.page_len = int(page_len)
        # None: slots' worst case + a couple of cached prefixes' worth
        self.num_pages = num_pages
        self.prefix_cache = bool(prefix_cache)


class _GenRequest:
    __slots__ = ("prompt", "max_new_tokens", "future", "t_submit",
                 "generated", "deadline", "blocks", "total_blocks",
                 "on_token", "logprobs", "want_logprobs")

    def __init__(self, prompt, max_new_tokens, future, t_submit,
                 deadline=None, on_token=None, want_logprobs=False):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.future = future
        self.t_submit = t_submit
        self.deadline = deadline  # absolute monotonic seconds, or None
        self.on_token = on_token  # per-token stream callback, or None
        self.want_logprobs = bool(want_logprobs)
        self.generated: List[int] = []
        self.logprobs: List[float] = []  # behavior logprob per token
        # paging facts, computed once at submit (the admission scan runs
        # under the engine lock and must stay cheap)
        self.blocks: List[Tuple[int, ...]] = []  # full prompt token-blocks
        self.total_blocks = 0                    # worst-case pages

    def edf_key(self) -> Tuple[float, float]:
        eff = self.deadline if self.deadline is not None \
            else self.t_submit + _EDF_DEFAULT_HORIZON_S
        return (eff, self.t_submit)


class _Slot:
    __slots__ = ("req", "length", "last_token", "table", "blocks", "shared")

    def __init__(self, n_blocks: int):
        self.req: Optional[_GenRequest] = None
        self.length = 0
        self.last_token = 0
        self.table = np.zeros(n_blocks, dtype=np.int32)  # page ids (0=scratch)
        self.blocks = 0   # allocated entries of `table`
        self.shared = 0   # leading entries borrowed from the prefix cache


def build_window_step(cfg, max_slots: int, n_blocks: int, page_len: int,
                      window: int):
    """The paged step for window size ``W = window``: embed ``W`` tokens
    per slot at positions ``lengths + [0..W)``, write their K/V through the
    page tables into the arenas, attend each window token causally against
    the page pool, and return the greedy argmax and its logprob at every
    window position.

    ``step(params, k_arenas, v_arenas, tables, tokens, lengths) -> (nxt
    [S, W] int32, logp [S, W] float32)``; ``tables`` [S, B], ``tokens`` [S,
    W] and ``lengths`` [S] are int32 tensors on the arenas' device. Unlike
    the JAX step, which returns new arenas, this one writes the arenas IN
    PLACE: a second copy of a 10 GB pool does not fit beside it.
    """
    nh = cfg.num_attention_heads
    h = cfg.hidden_size
    hd = h // nh
    eps = cfg.layer_norm_epsilon
    scale = 1.0 / math.sqrt(hd)
    S, B, W, PL = max_slots, n_blocks, window, page_len

    def ln(x, w, b):
        # population variance, eps inside the rsqrt
        return TF.layer_norm(x, (h,), w, b, eps)

    @torch.no_grad()
    def step(params, k_arenas, v_arenas, tables, tokens, lengths):
        P = k_arenas[0].shape[0]
        dev = tokens.device
        pos = lengths[:, None] + torch.arange(W, dtype=torch.int32,
                                              device=dev)         # [S, W]
        pos_idx = pos.clamp(max=params["pos"].shape[0] - 1).long()
        x = params["embed"][tokens.long()] + params["pos"][pos_idx]
        # write targets: page-table lookup of each window token's block;
        # blocks past the table (or past a request's allocation: table
        # entry 0) land in the scratch page, never another slot's pages.
        # The scratch page takes duplicate writes (plain assignment, any
        # one wins) and its contents are never visible.
        blk = torch.div(pos, PL, rounding_mode="floor")
        pidx = torch.gather(tables, 1, blk.clamp(max=B - 1).long())
        pidx = torch.where(blk < B, pidx, 0)
        flat = (pidx * PL + pos % PL).reshape(-1).long()          # [S*W]
        for p, kc, vc in zip(params["layers"], k_arenas, v_arenas):
            h1 = ln(x, p["ln1_w"], p["ln1_b"])
            qkv = TF.linear(h1, p["qkv_w"], p["qkv_b"]).view(S, W, 3, nh, hd)
            q, k1, v1 = qkv.unbind(2)
            kc.view(P * PL, nh, hd)[flat] = k1.reshape(S * W, nh, hd)
            vc.view(P * PL, nh, hd)[flat] = v1.reshape(S * W, nh, hd)
            # key j visible iff j <= pos[s, w]
            ctx = paged_attention(q, kc, vc, tables, pos, scale=scale)
            x = x + TF.linear(ctx.reshape(S, W, h), p["out_w"], p["out_b"])
            h2 = ln(x, p["ln2_w"], p["ln2_b"])
            m = TF.gelu(TF.linear(h2, p["fc_in_w"], p["fc_in_b"]),
                        approximate="tanh")
            x = x + TF.linear(m, p["fc_out_w"], p["fc_out_b"])
        xf = ln(x, params["lnf_w"], params["lnf_b"])
        logits = TF.linear(xf, params["embed"])                  # [S, W, V]
        nxt = logits.argmax(dim=-1).to(torch.int32)
        # behavior logprob of the greedy pick, in f32 (bf16 logits
        # renormalize poorly)
        lf = logits.float()
        logp = lf.amax(dim=-1) - torch.logsumexp(lf, dim=-1)
        return nxt, logp

    return step


class GenerationEngine(EngineBase):
    """Continuous-batching generation server over a ``GPTForCausalLM``.

    ::

        eng = GenerationEngine(model, GenerationConfig(max_slots=4))
        eng.start()
        fut = eng.submit(prompt_ids, max_new_tokens=8, deadline_ms=None)
        full = fut.result()          # np.int64 [len(prompt) + generated]
        eng.stats()
        eng.close()

    The engine runs where the model's weights are; ``device`` (``None`` =
    CUDA) must name that device. Requests queue under admission control
    (``QueueFull`` beyond ``max_queue``); a prompt joins the decode batch
    as soon as a slot AND enough KV pages free. Slot-join order is
    earliest-deadline-first; requests that expire while queued are shed
    with ``DeadlineExceeded``. With ``prefix_cache`` on, a prompt whose
    leading page-blocks are cached reuses those pages and prefills only its
    suffix.
    """

    _close_timeout = 60.0

    def __init__(self, model, config: Optional[GenerationConfig] = None,
                 name: Optional[str] = None, device=None):
        self.config = config or GenerationConfig()
        super().__init__(name or f"gen#{next(_GEN_NO)}")
        dev = resolve_device(device)
        mcfg = model.config
        self._params = gpt_engine_params(model)
        wdev = self._params["embed"].device
        if wdev.type != dev.type or (dev.index is not None
                                     and wdev.index != dev.index):
            raise ValueError(f"model weights on {wdev}, engine device {dev}")
        self.device = wdev
        self.max_len = int(self.config.max_seq_len
                           or mcfg.max_position_embeddings)
        if self.max_len > mcfg.max_position_embeddings:
            raise ValueError(
                f"max_seq_len {self.max_len} exceeds the model's position "
                f"table ({mcfg.max_position_embeddings})")
        for b in self.config.prefill_buckets:
            if b > self.max_len:
                raise ValueError(
                    f"prefill bucket {b} exceeds max_seq_len {self.max_len}")
        nh = mcfg.num_attention_heads
        hd = mcfg.hidden_size // nh
        S = self.config.max_slots
        pl = self.config.page_len
        self._pl = pl
        self._n_blocks = B = -(-self.max_len // pl)  # ceil
        num_pages = self.config.num_pages
        if num_pages is None:
            # every slot's worst case + two cached prefixes' worth + scratch
            num_pages = S * B + 2 * B + 1
        self._pool = PagedKVPool(mcfg.num_hidden_layers, num_pages, pl,
                                 nh, hd, self._params["embed"].dtype,
                                 prefix_cache=self.config.prefix_cache,
                                 device=self.device)
        self._mcfg = mcfg
        self._windows: Dict[int, Any] = {}  # W -> window step
        self._slots = [_Slot(B) for _ in range(S)]
        self.metrics.gauge("kv_headroom", self.kv_headroom)
        self.metrics.gauge("prefix_cache", self._prefix_cache_stats)

    def _prefix_cache_stats(self) -> Dict[str, Any]:
        trie = self._pool.trie
        if trie is None:
            return {}
        st = trie.stats()
        st["misses"] = st["lookups"] - st["hits"]
        return st

    def _window(self, W: int):
        fn = self._windows.get(W)
        if fn is None:
            fn = build_window_step(self._mcfg, self.config.max_slots,
                                   self._n_blocks, self._pl, W)
            self._windows[W] = fn
        return fn

    def _run_window(self, tables, tokens, lengths):
        """One window step from host arrays; returns host (nxt, logp)."""
        dev = self.device
        nxt, lp = self._window(tokens.shape[1])(
            self._params, self._pool.k, self._pool.v,
            torch.from_numpy(tables).to(dev),
            torch.from_numpy(tokens).to(dev),
            torch.from_numpy(lengths).to(dev))
        return nxt.cpu().numpy(), lp.cpu().numpy()

    def warmup(self):
        """Run every window size once (decode and each prefill bucket)
        against the scratch page: builds the kernels and touches every
        shape before the first request."""
        S, B = self.config.max_slots, self._n_blocks
        tables = np.zeros((S, B), dtype=np.int32)
        lengths = np.zeros(S, dtype=np.int32)
        for W in sorted({1, *self.config.prefill_buckets}):
            self._run_window(tables, np.zeros((S, W), dtype=np.int32),
                             lengths)
        self.metrics.inc("warmup_runs")
        return self

    # -- submission -----------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 16,
               deadline_ms: Optional[float] = None,
               on_token=None, return_logprobs: bool = False) -> "Future":
        """Queue one prompt (1-D int array). The future resolves to the
        full sequence (prompt + generated) as a 1-D np.int64 array. A
        ``deadline_ms`` bounds QUEUE time: expired requests are shed with
        ``DeadlineExceeded`` before prefill, and queued requests join
        slots earliest-deadline-first. ``on_token(t)`` fires once per
        emitted token in order, on the engine's worker thread.

        ``return_logprobs=True`` makes the future resolve to ``(full_seq,
        logprobs)`` — a float32 array, one behavior logprob per generated
        token — and calls ``on_token(t, lp)`` with two arguments."""
        self.metrics.inc("requests_total")
        fut: Future = Future()
        prompt = np.asarray(prompt_ids)
        if prompt.ndim != 1 or prompt.size == 0 or \
                not np.issubdtype(prompt.dtype, np.integer):
            return self._reject(fut, "prompt must be a non-empty 1-D "
                                     "integer array")
        if max_new_tokens < 1:
            return self._reject(fut, "max_new_tokens must be >= 1")
        if self._prefill_bucket(len(prompt)) is None:
            return self._reject(
                fut, f"prompt length {len(prompt)} exceeds the largest "
                     f"prefill bucket {self.config.prefill_buckets[-1]}")
        if len(prompt) + max_new_tokens > self.max_len:
            return self._reject(
                fut, f"prompt ({len(prompt)}) + max_new_tokens "
                     f"({max_new_tokens}) exceeds max_seq_len "
                     f"{self.max_len}")
        needed = -(-(len(prompt) + max_new_tokens) // self._pl)
        if needed > self._pool.allocator.usable_pages:
            # a request that could never hold enough pages is rejected;
            # one that merely has to wait for pages stays queued
            return self._reject(
                fut, f"request needs {needed} KV pages; the pool holds "
                     f"{self._pool.allocator.usable_pages}")
        t_submit = time.monotonic()
        deadline = None if deadline_ms is None \
            else t_submit + deadline_ms / 1000.0
        req = _GenRequest(prompt.astype(np.int64), int(max_new_tokens), fut,
                          t_submit, deadline, on_token=on_token,
                          want_logprobs=return_logprobs)
        req.blocks = token_blocks(req.prompt, self._pl)
        req.total_blocks = needed
        self._enqueue(req, self.config.max_queue)
        return fut

    def _reject(self, fut: Future, msg: str) -> Future:
        self.metrics.inc("errors_total")
        fut.set_exception(BadRequest(msg))
        return fut

    def _prefill_bucket(self, n: int) -> Optional[int]:
        for b in self.config.prefill_buckets:
            if b >= n:
                return b
        return None

    # -- router probes --------------------------------------------------------
    def kv_headroom(self) -> float:
        """Free fraction of the KV page pool."""
        a = self._pool.allocator
        return round(a.free_pages / max(a.usable_pages, 1), 4)

    def prefix_match_tokens(self, prompt_ids, blocks=None) -> int:
        """Tokens of ``prompt_ids`` whose KV pages this engine already
        caches (takes no refs, bumps no LRU)."""
        trie = self._pool.trie
        if trie is None:
            return 0
        if blocks is None:
            prompt = np.asarray(prompt_ids).reshape(-1)
            blocks = token_blocks(prompt, self._pl,
                                  limit=(len(prompt) - 1) // self._pl)
        return trie.match_len(blocks) * self._pl

    # -- the continuous-batching loop -----------------------------------------
    def _active(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s.req is not None]

    def _blocks_needed(self, req: _GenRequest) -> int:
        """Pages a request must be able to allocate at join time (worst
        case, minus what the prefix cache already holds)."""
        trie = self._pool.trie
        if trie is None:
            return req.total_blocks
        m = trie.match_len(req.blocks[: (len(req.prompt) - 1) // self._pl])
        return req.total_blocks - m

    def _next_request(self) -> Optional[_GenRequest]:
        """Shed expired queued requests, then pick the earliest-deadline
        queued request whose KV pages can be allocated right now."""
        now = time.monotonic()
        shed: List[_GenRequest] = []
        picked: Optional[_GenRequest] = None
        with self._cond:
            for r in list(self._queue):
                if r.deadline is not None and now > r.deadline:
                    self._queue.remove(r)
                    shed.append(r)
            for r in sorted(self._queue, key=_GenRequest.edf_key):
                if self._pool.can_allocate(self._blocks_needed(r)):
                    self._queue.remove(r)
                    picked = r
                    break
        for r in shed:  # outside the lock: future callbacks may re-submit
            self.metrics.inc("shed_total")
            if not r.future.done():
                r.future.set_exception(DeadlineExceeded(
                    "deadline expired while queued"))
        return picked

    def _worker(self):
        with torch.no_grad():
            self._loop()

    def _loop(self):
        while True:
            # admit queued prompts into free slots (join mid-flight,
            # earliest deadline first, bounded by KV page headroom)
            while True:
                free = next((i for i, s in enumerate(self._slots)
                             if s.req is None), None)
                if free is None:
                    break
                req = self._next_request()
                if req is None:
                    break
                try:
                    self._admit(free, req)
                except PoolExhausted:
                    # transient: in-flight releases will free pages —
                    # requeue at the front, decode meanwhile
                    with self._cond:
                        self._queue.appendleft(req)
                    break
                except Exception as e:  # isolate: fail this prompt only
                    if not req.future.done():
                        req.future.set_exception(e)
                    self.metrics.inc("errors_total")
                    slot = self._slots[free]
                    self._release_pages(slot)
                    slot.req, slot.length, slot.last_token = None, 0, 0
            active = self._active()
            if not active:
                with self._cond:
                    if self._closed and not self._queue:
                        return
                    if not self._queue:
                        self._cond.wait()  # submit/close notify
                continue
            try:
                self._decode_once(active)
            except Exception as e:  # decode fault: fail the in-flight batch
                for i in active:
                    s = self._slots[i]
                    if s.req is not None and not s.req.future.done():
                        s.req.future.set_exception(e)
                    self._release_slot(i)
                self.metrics.inc("errors_total", len(active))
                self.metrics.inc("batch_failures")

    def _admit(self, slot_no: int, req: _GenRequest):
        """Join a prompt: borrow its cached prefix pages, allocate private
        pages for the rest, prefill ONLY the uncached suffix through the
        window step, and adopt its full prompt blocks into the prefix
        cache. The first generated token is the window's argmax at the
        last real prompt position."""
        p = len(req.prompt)
        pl = self._pl
        total_blocks = req.total_blocks
        t0 = time.monotonic()
        s = self._slots[slot_no]
        s.table[:] = 0
        # prefix reuse: longest cached chain of full prompt blocks, capped
        # so at least one suffix token remains to produce the first logits
        shared_pages: List[int] = []
        trie = self._pool.trie
        if trie is not None:
            shared_pages = trie.match(req.blocks[: (p - 1) // pl], pl,
                                      self._pool.allocator)
        m = len(shared_pages)
        try:
            private = self._pool.allocate(total_blocks - m)
        except PoolExhausted:
            for pg in shared_pages:
                self._pool.allocator.release(pg)
            raise
        s.table[:m] = shared_pages
        s.table[m:total_blocks] = private
        s.blocks, s.shared = total_blocks, m
        # COW hook: every block the decode path writes must be exclusively
        # ours. The trie shares FULL prompt blocks only, so this is a
        # no-op guard today.
        for bi in range(p // pl, total_blocks):
            pg, copied = self._pool.ensure_writable(int(s.table[bi]))
            if copied:
                s.table[bi] = pg
        # suffix prefill: one window-step call, this slot's pages only
        start = m * pl
        suffix = req.prompt[start:p]
        W = self._prefill_bucket(len(suffix))
        S, B = self.config.max_slots, self._n_blocks
        tokens = np.zeros((S, W), dtype=np.int32)
        tokens[slot_no, :len(suffix)] = suffix
        lengths = np.zeros(S, dtype=np.int32)
        lengths[slot_no] = start
        tables = np.zeros((S, B), dtype=np.int32)
        tables[slot_no] = s.table
        nxt, lp = self._run_window(tables, tokens, lengths)
        first = int(nxt[slot_no, len(suffix) - 1])
        first_lp = float(lp[slot_no, len(suffix) - 1])
        # adopt this prompt's full blocks so the next same-prefix request
        # skips their prefill
        if trie is not None:
            fp = p // pl
            trie.insert(req.blocks[:fp], [int(x) for x in s.table[:fp]],
                        self._pool.allocator)
            self.metrics.inc("prefix_hit_tokens", m * pl)
        self.metrics.inc("prompt_tokens_total", p)
        self.metrics.inc("prefills_total")
        if m:
            self.metrics.inc("prefix_hits")
        self.metrics.observe_queue_wait((t0 - req.t_submit) * 1e3)
        self.metrics.inc("prefill_ms_total", (time.monotonic() - t0) * 1e3)
        s.req = req
        s.length = p
        s.last_token = first
        self._note_token(req, first, first_lp)
        self._emit_finish_check(slot_no)

    def _note_token(self, req: _GenRequest, t: int, lp: float) -> None:
        """One emitted token: record it (token + behavior logprob) and fire
        the stream callback (a client callback must never sink the decode
        batch)."""
        req.generated.append(int(t))
        req.logprobs.append(float(lp))
        if req.on_token is not None:
            try:
                if req.want_logprobs:
                    req.on_token(int(t), float(lp))
                else:
                    req.on_token(int(t))
            except Exception:
                self.metrics.inc("on_token_errors")

    def _decode_once(self, active: List[int]):
        """One W=1 decode round: one token per active slot."""
        S, B = self.config.max_slots, self._n_blocks
        tokens = np.zeros((S, 1), dtype=np.int32)
        lengths = np.zeros(S, dtype=np.int32)
        tables = np.zeros((S, B), dtype=np.int32)
        for i in active:
            s = self._slots[i]
            tokens[i, 0] = s.last_token
            lengths[i] = min(s.length, self.max_len - 1)
            tables[i] = s.table
        t0 = time.monotonic()
        n, lpn = self._run_window(tables, tokens, lengths)
        self.metrics.inc("decode_ms_total", (time.monotonic() - t0) * 1e3)
        self.metrics.inc("decode_steps")
        self.metrics.inc("slot_rounds", len(active))
        self.metrics.observe_occupancy(len(active) / S)
        for i in active:
            s = self._slots[i]
            t = int(n[i, 0])
            s.length += 1
            s.last_token = t
            self._note_token(s.req, t, lpn[i, 0])
            self._emit_finish_check(i)
        self.metrics.inc("tokens_total", len(active))

    def _emit_finish_check(self, slot_no: int) -> bool:
        """Finish-and-release when the slot's request is done (budget
        reached, EOS, or context exhausted). Returns True when released."""
        s = self._slots[slot_no]
        req = s.req
        eos = self.config.eos_token_id
        done = (len(req.generated) >= req.max_new_tokens
                or (eos is not None and req.generated[-1] == eos)
                or s.length >= self.max_len - 1)
        if not done:
            return False
        full = np.concatenate([req.prompt,
                               np.asarray(req.generated, dtype=np.int64)])
        if not req.future.done():
            if req.want_logprobs:
                req.future.set_result(
                    (full, np.asarray(req.logprobs, dtype=np.float32)))
            else:
                req.future.set_result(full)
        self.metrics.observe_latency((time.monotonic() - req.t_submit) * 1e3)
        self.metrics.inc("responses_total")
        self.metrics.mark_done()
        self._release_slot(slot_no)
        return True

    def _release_pages(self, s: _Slot) -> None:
        """Drop this slot's page refs (pages the trie adopted survive on
        its ref and stay reusable)."""
        for bi in range(s.blocks):
            self._pool.allocator.release(int(s.table[bi]))
        s.table[:] = 0
        s.blocks = s.shared = 0

    def _release_slot(self, slot_no: int) -> None:
        s = self._slots[slot_no]
        self._release_pages(s)
        s.req = None
        s.length = 0
        s.last_token = 0

    def stats(self) -> Dict[str, Any]:
        snap = self._stats_base()
        snap["max_slots"] = self.config.max_slots
        snap["active_slots"] = len(self._active())
        snap["kv_pages"] = self._pool.stats()
        c = snap["counters"]
        pt = c.get("prompt_tokens_total", 0)
        snap["prefix_hit_rate"] = round(
            c.get("prefix_hit_tokens", 0) / pt, 4) if pt else 0.0
        rounds = c.get("slot_rounds", 0)
        snap["effective_tokens_per_step"] = round(
            c.get("tokens_total", 0) / rounds, 3) if rounds else 0.0
        steps = c.get("decode_steps", 0)
        snap["decode_step_ms_mean"] = round(
            c.get("decode_ms_total", 0) / steps, 3) if steps else 0.0
        return snap

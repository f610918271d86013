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
  ``W = 1`` is decode; ``W = k + 1`` scores a draft model's ``k``
  proposals in one call (speculative decoding: every emitted token is the
  target's own argmax, so the output is token for token the greedy path);
  ``W = bucket`` prefills a prompt suffix.
- The draft model decodes through a dense per-slot arena
  (:func:`build_decode_step`), prefilled by its own cached forward.
- ``swap_weights`` lands a new weight set at a step boundary with no
  request in flight; ``export_kv_pages`` / ``install_kv_pages`` move a
  prompt's cached pages out of one engine and into another; evicted
  prefix pages can spill to an int8 host tier and come back from it.

Greedy decoding (``GPTForCausalLM.generate``'s argmax contract). Left for
later slices: fault injection and the observability hubs.
"""
from __future__ import annotations

import itertools
import math
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from ..device import resolve_device
from ..kernels.paged_attention import paged_attention
from ..models.convert import gpt_engine_params
from .base import (BadRequest, DeadlineExceeded, EngineBase, EngineClosed,
                   _injector)
from .paged_kv import HostPagePool, PagedKVPool, PoolExhausted, token_blocks
from .speculative import greedy_accept

__all__ = ["GenerationConfig", "GenerationEngine", "build_window_step",
           "build_decode_step", "flatten_gpt_params", "nest_gpt_params"]

_GEN_NO = itertools.count(1)

# EDF fairness bound: a request WITHOUT a deadline is ordered as if due
# this long after arrival, so sustained deadline-bearing traffic can delay
# it by at most the horizon — never starve it. Ordering only; shedding
# applies to explicit deadlines alone.
_EDF_DEFAULT_HORIZON_S = 300.0


class GenerationConfig:
    """Page pool + prompt bucket + speculative-decode declaration."""

    def __init__(self, max_slots: int = 4, max_seq_len: Optional[int] = None,
                 prefill_buckets: Tuple[int, ...] = (16, 32, 64, 128),
                 max_queue: int = 256, eos_token_id: Optional[int] = None,
                 page_len: int = 16, num_pages: Optional[int] = None,
                 prefix_cache: bool = True, draft_model=None,
                 spec_tokens: int = 4, warm_pool_bytes: int = 0,
                 warm_admit_threshold: int = 2):
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
        self.draft_model = draft_model       # GPTForCausalLM or None
        self.spec_tokens = int(spec_tokens)  # draft proposals per round
        # warm tier: evicted prefix pages spill (int8) to host RAM and
        # restore instead of re-prefilling. 0 = off (the default keeps the
        # device tier bit-exact; int8 restores are approximate KV)
        self.warm_pool_bytes = int(warm_pool_bytes)
        self.warm_admit_threshold = int(warm_admit_threshold)


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
    __slots__ = ("req", "length", "last_token", "t0", "table", "blocks",
                 "shared")

    def __init__(self, n_blocks: int):
        self.req: Optional[_GenRequest] = None
        self.length = 0
        self.last_token = 0
        self.t0 = 0.0  # residency start (occupancy track)
        self.table = np.zeros(n_blocks, dtype=np.int32)  # page ids (0=scratch)
        self.blocks = 0   # allocated entries of `table`
        self.shared = 0   # leading entries borrowed from the prefix cache


def flatten_gpt_params(tree) -> Dict[str, Any]:
    """Flatten the engine's param dict to ``{dotted_name: tensor}`` — the
    wire shape of a weight push. The names are the JAX package's letter for
    letter; the Linear weights keep the port's ``[out, in]`` layout."""
    flat = {"embed": tree["embed"], "pos": tree["pos"],
            "lnf_w": tree["lnf_w"], "lnf_b": tree["lnf_b"]}
    for i, L in enumerate(tree["layers"]):
        for k, v in L.items():
            flat[f"layers.{i}.{k}"] = v
    return flat


def nest_gpt_params(flat) -> Dict[str, Any]:
    """Inverse of :func:`flatten_gpt_params`."""
    tree: Dict[str, Any] = {"layers": []}
    layers: Dict[int, Dict[str, Any]] = {}
    for name, v in flat.items():
        if name.startswith("layers."):
            _, idx, key = name.split(".", 2)
            layers.setdefault(int(idx), {})[key] = v
        else:
            tree[name] = v
    for i in sorted(layers):
        if i != len(tree["layers"]):
            raise ValueError(f"non-contiguous layer index {i}")
        tree["layers"].append(layers[i])
    return tree


def _layer_norm(h: int, eps: float):
    def ln(x, w, b):
        # population variance, eps inside the rsqrt
        return TF.layer_norm(x, (h,), w, b, eps)
    return ln


def build_decode_step(cfg, max_slots: int, max_len: int):
    """The draft model's decode step over a dense SLOT arena: embed one
    token per slot at position ``lengths``, write its K/V into the slot's
    row of the ``[S, max_len, nh, hd]`` per-layer caches, attend it
    against the slot's rows ``<= lengths``, and return the greedy argmax.
    Composed in plain PyTorch, as the JAX package composes it in XLA
    einsums (the draft is small; a dense arena beats paging for it).

    ``step(params, k_caches, v_caches, tokens, lengths) -> nxt [S] int32``;
    ``tokens`` and ``lengths`` are [S] int32 tensors on the caches' device.
    The caches are written IN PLACE."""
    nh = cfg.num_attention_heads
    h = cfg.hidden_size
    hd = h // nh
    scale = 1.0 / math.sqrt(hd)
    S = max_slots
    ln = _layer_norm(h, cfg.layer_norm_epsilon)

    @torch.no_grad()
    def step(params, k_caches, v_caches, tokens, lengths):
        dev = tokens.device
        pos_idx = lengths.clamp(max=params["pos"].shape[0] - 1).long()
        x = params["embed"][tokens.long()] + params["pos"][pos_idx]  # [S, h]
        mask = torch.arange(max_len, device=dev)[None, :] <= \
            lengths[:, None]                                      # [S, L]
        slot_idx = torch.arange(S, device=dev)
        wr = lengths.clamp(max=max_len - 1).long()
        for p, kc, vc in zip(params["layers"], k_caches, v_caches):
            h1 = ln(x, p["ln1_w"], p["ln1_b"])
            qkv = TF.linear(h1, p["qkv_w"], p["qkv_b"]).view(S, 3, nh, hd)
            q, k1, v1 = qkv.unbind(1)
            kc[slot_idx, wr] = k1
            vc[slot_idx, wr] = v1
            logits = torch.einsum("shd,sLhd->shL", q, kc).float() * scale
            logits = logits.masked_fill(~mask[:, None, :], -1e30)
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            ctx = torch.einsum("shL,sLhd->shd", probs, vc).reshape(S, h)
            x = x + TF.linear(ctx, p["out_w"], p["out_b"])
            h2 = ln(x, p["ln2_w"], p["ln2_b"])
            m = TF.gelu(TF.linear(h2, p["fc_in_w"], p["fc_in_b"]),
                        approximate="tanh")
            x = x + TF.linear(m, p["fc_out_w"], p["fc_out_b"])
        xf = ln(x, params["lnf_w"], params["lnf_b"])
        logits = TF.linear(xf, params["embed"])                  # [S, V]
        return logits.argmax(dim=-1).to(torch.int32)

    return step


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
    scale = 1.0 / math.sqrt(hd)
    S, B, W, PL = max_slots, n_blocks, window, page_len
    ln = _layer_norm(h, cfg.layer_norm_epsilon)

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
    suffix. With a ``draft_model``, each decode round proposes
    ``spec_tokens`` draft tokens and verifies them in one window-step call
    — output stays token for token the target model's greedy path.
    """

    _close_timeout = 60.0

    def __init__(self, model, config: Optional[GenerationConfig] = None,
                 name: Optional[str] = None, device=None):
        self.config = config or GenerationConfig()
        super().__init__(name or f"gen#{next(_GEN_NO)}")
        dev = resolve_device(device)
        mcfg = model.config
        self._params = gpt_engine_params(model)
        self.device = self._check_device(self._params, dev, "model")
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
        warm = None
        if self.config.warm_pool_bytes and self.config.prefix_cache:
            warm = HostPagePool(
                capacity_bytes=self.config.warm_pool_bytes,
                admit_threshold=self.config.warm_admit_threshold)
        self._pool = PagedKVPool(mcfg.num_hidden_layers, num_pages, pl,
                                 nh, hd, self._params["embed"].dtype,
                                 prefix_cache=self.config.prefix_cache,
                                 device=self.device, warm_pool=warm)
        # cross-thread ops the worker must execute (the allocator and the
        # arenas are worker-owned): (fn, Future) pairs — the KV
        # export/install seam
        self._ops: deque = deque()
        self._mcfg = mcfg
        self._windows: Dict[int, Any] = {}  # W -> window step

        # -- speculative decoding (draft model) --------------------------
        self.spec_k = 0
        self._spec_on = True  # brownout toggle: set_speculative(False)
        if self.config.draft_model is not None:
            dm = self.config.draft_model
            dm.eval()
            dcfg = dm.config
            if dcfg.vocab_size != mcfg.vocab_size:
                raise ValueError(
                    f"draft vocab {dcfg.vocab_size} != target vocab "
                    f"{mcfg.vocab_size}")
            if dcfg.max_position_embeddings < self.max_len:
                raise ValueError(
                    f"draft position table ({dcfg.max_position_embeddings}) "
                    f"shorter than max_seq_len {self.max_len}")
            self.spec_k = max(1, self.config.spec_tokens)
            self._draft = dm
            self._dparams = gpt_engine_params(dm)
            self._check_device(self._dparams, self.device, "draft model")
            dnh = dcfg.num_attention_heads
            dhd = dcfg.hidden_size // dnh
            dlen = B * pl
            shape = (S, dlen, dnh, dhd)
            ddtype = self._dparams["embed"].dtype
            self._dk = [torch.zeros(shape, dtype=ddtype, device=self.device)
                        for _ in range(dcfg.num_hidden_layers)]
            self._dv = [torch.zeros(shape, dtype=ddtype, device=self.device)
                        for _ in range(dcfg.num_hidden_layers)]
            self._draft_step = build_decode_step(dcfg, S, dlen)

        self._slots = [_Slot(B) for _ in range(S)]
        # a pending weight swap lands at the first ZERO-ACTIVE step
        # boundary — admission pauses while it pends, so in-flight requests
        # finish on the version they started on
        self._pending_swap = None  # (params, version, Future) or None
        # slot-occupancy history: (slot, t0, t1, tokens) per residency
        self._slot_hist: deque = deque(maxlen=512)
        self._residencies = 0
        self._t_start = time.monotonic()
        self.metrics.gauge("slot_occupancy", self.slot_occupancy)
        self.metrics.gauge("kv_headroom", self.kv_headroom)
        self.metrics.gauge("prefix_cache", self._prefix_cache_stats)

    @staticmethod
    def _check_device(params, dev, what):
        wdev = params["embed"].device
        if wdev.type != dev.type or (dev.index is not None
                                     and wdev.index != dev.index):
            raise ValueError(f"{what} weights on {wdev}, engine device {dev}")
        return wdev

    def _prefix_cache_stats(self) -> Dict[str, Any]:
        trie = self._pool.trie
        if trie is None:
            return {}
        st = trie.stats()
        st["misses"] = st["lookups"] - st["hits"]
        if self._pool.warm is not None:
            st["warm"] = self._pool.warm.stats()
        return st

    def _window(self, W: int):
        """The window step for window size ``W`` (built once per size;
        sizes come from the closed set {1, spec_k + 1} and the buckets)."""
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
        """Run every window size once (decode, speculative verify and each
        prefill bucket) against the scratch page, and the draft's decode
        step and prefill at each bucket: builds the kernels and touches
        every shape before the first request."""
        S, B = self.config.max_slots, self._n_blocks
        tables = np.zeros((S, B), dtype=np.int32)
        lengths = np.zeros(S, dtype=np.int32)
        sizes = {1, *self.config.prefill_buckets}
        if self.spec_k:
            sizes.add(self.spec_k + 1)
        with torch.no_grad():
            for W in sorted(sizes):
                self._run_window(tables, np.zeros((S, W), dtype=np.int32),
                                 lengths)
            if self.spec_k:
                z = torch.zeros(S, dtype=torch.int32, device=self.device)
                self._draft_step(self._dparams, self._dk, self._dv, z, z)
                # slot 0's rows are overwritten at the first real admit
                for b in self.config.prefill_buckets:
                    self._draft_prefill(0, np.zeros(b, dtype=np.int64))
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

    def set_speculative(self, enabled: bool) -> None:
        """Brownout lever: toggle draft-model speculation per decode round.
        Off = classic W = 1 decode, shedding the draft's k dense steps per
        round. The draft's prompt prefill keeps running so a later
        re-enable stays correct — only its proposal quality degrades until
        its cache catches up (the target verifies every token, so output
        never changes)."""
        self._spec_on = bool(enabled)

    def speculative_enabled(self) -> bool:
        return bool(self.spec_k) and self._spec_on

    # -- in-place weight push -------------------------------------------------
    def _coerce_swap_state(self, state) -> Dict[str, Any]:
        """Validate an incoming weight set against the live one and land it
        on the engine's device in its dtype. Accepts a ``GPTForCausalLM``,
        the nested param dict, or the flat ``{dotted_name: array}`` wire
        shape. The result holds NEW tensors (or the incoming ones where
        they already match): nothing is copied into the live weights, whose
        storage the model and other engines over it share."""
        if hasattr(state, "gpt"):
            state = gpt_engine_params(state)
        if "layers" not in state:
            state = nest_gpt_params(dict(state))

        def conv(old, new, path):
            if new is None:
                raise ValueError(f"swap_weights: missing param {path!r}")
            t = torch.as_tensor(new).detach()
            if tuple(t.shape) != tuple(old.shape):
                raise ValueError(
                    f"swap_weights: {path!r} shape {tuple(t.shape)} != live "
                    f"shape {tuple(old.shape)}")
            return t.to(device=old.device, dtype=old.dtype)

        if len(state.get("layers", ())) != len(self._params["layers"]):
            raise ValueError(
                f"swap_weights: {len(state.get('layers', ()))} layers != "
                f"live {len(self._params['layers'])}")
        new = {k: conv(v, state.get(k), k)
               for k, v in self._params.items() if k != "layers"}
        new["layers"] = [
            {k: conv(v, state["layers"][i].get(k), f"layers.{i}.{k}")
             for k, v in L.items()}
            for i, L in enumerate(self._params["layers"])]
        return new

    def swap_weights(self, state, version: Optional[int] = None,
                     timeout: Optional[float] = None) -> int:
        """Replace the TARGET model's served weights. The swap is staged and
        applied by the worker at the first step boundary with zero active
        slots: admission pauses while it pends, so every in-flight request
        finishes on the weight version it started on, and the first request
        admitted afterwards runs the new version. The prefix cache and the
        warm tier are dropped at the boundary (old-version KV is garbage
        under new weights). The draft keeps its weights — it only
        proposes. Returns the new ``weight_version`` once applied."""
        params = self._coerce_swap_state(state)
        fut: Future = Future()
        with self._cond:
            if self._closed:
                raise EngineClosed("engine closed")
            if self._pending_swap is not None:
                raise RuntimeError("a weight swap is already pending")
            ver = int(version) if version is not None \
                else self.weight_version + 1
            self._pending_swap = (params, ver, fut)
            self._cond.notify_all()
            started = self._thread is not None
        if not started:
            self._apply_swap()  # no worker: nothing in flight to drain
        return fut.result(timeout=120.0 if timeout is None else timeout)

    def _apply_swap(self) -> None:
        """Land the staged weights (worker thread at a zero-active
        boundary, or inline when no worker runs)."""
        with self._cond:
            pend, self._pending_swap = self._pending_swap, None
        if pend is None:
            return
        params, ver, fut = pend
        self._params = params
        trie = self._pool.trie
        if trie is not None:  # cached prefixes are old-version KV
            trie.release_all(self._pool.allocator)
        if self._pool.warm is not None:
            self._pool.warm.clear()
        self.weight_version = ver
        self.metrics.inc("weight_swaps")
        if not fut.done():
            fut.set_result(ver)

    # -- router probes --------------------------------------------------------
    def kv_headroom(self) -> float:
        """Free fraction of the KV page pool."""
        a = self._pool.allocator
        return round(a.free_pages / max(a.usable_pages, 1), 4)

    def prefix_match_tokens(self, prompt_ids, blocks=None) -> int:
        """Tokens of ``prompt_ids`` whose KV pages this engine already
        caches (takes no refs, bumps no LRU). A caller probing several
        replicas may pass the precomputed ``token_blocks(prompt, page_len,
        limit=(p-1)//page_len)``."""
        trie = self._pool.trie
        if trie is None:
            return 0
        if blocks is None:
            prompt = np.asarray(prompt_ids).reshape(-1)
            blocks = token_blocks(prompt, self._pl,
                                  limit=(len(prompt) - 1) // self._pl)
        return trie.match_len(blocks) * self._pl

    # -- KV page transfer -----------------------------------------------------
    def _run_on_worker(self, fn, timeout: float = 60.0):
        """Run ``fn()`` on the engine's worker thread at a step boundary and
        return its result (the allocator and the arenas are worker-owned:
        the window step updates the arenas in place). Runs inline when no
        worker thread exists yet."""
        with self._cond:
            if self._closed:
                raise EngineClosed("engine closed")
            started = self._thread is not None
            if started:
                fut: Future = Future()
                self._ops.append((fn, fut))
                self._cond.notify_all()
        if not started:
            return fn()
        return fut.result(timeout=timeout)

    def _drain_ops(self) -> None:
        """Execute queued cross-thread ops (worker thread, step boundary)."""
        while True:
            with self._cond:
                if not self._ops:
                    return
                fn, fut = self._ops.popleft()
            try:
                res = fn()
            except Exception as e:
                if not fut.done():
                    fut.set_exception(e)
            else:
                if not fut.done():
                    fut.set_result(res)

    def export_kv_pages(self, prompt_ids):
        """Read the cached KV of ``prompt_ids``' full prompt blocks out of
        the page pool. Returns ``(n_pages, k_stacks, v_stacks)`` with
        per-layer ``[n, page_len, heads, dim]`` CPU tensors. Raises
        ``KeyError`` when the prompt's blocks are not all cached (the
        caller falls back to re-prefill)."""
        prompt = np.asarray(prompt_ids).reshape(-1)
        blocks = token_blocks(prompt, self._pl)

        def _export():
            trie = self._pool.trie
            if trie is None:
                raise KeyError("prefix cache disabled: nothing to export")
            if not blocks:
                return 0, [], []
            pages = trie.match(blocks, self._pl, self._pool.allocator)
            try:
                if len(pages) < len(blocks):
                    raise KeyError(
                        f"only {len(pages)}/{len(blocks)} prompt blocks "
                        f"cached — cannot export")
                k_stacks, v_stacks = self._pool.read_pages(pages)
                return len(pages), k_stacks, v_stacks
            finally:
                for pg in pages:
                    self._pool.allocator.release(pg)

        out = self._run_on_worker(_export)
        self.metrics.inc("kv_exports")
        return out

    def install_kv_pages(self, prompt_ids, k_stacks, v_stacks) -> int:
        """Install shipped page CONTENTS for ``prompt_ids``' full prompt
        blocks: allocate pages, scatter-write the K/V, and adopt the chain
        into the prefix cache. The next submit sharing this prompt prefix
        reuses the pages instead of prefilling. Returns pages newly adopted
        (blocks already cached keep their pages — first writer wins)."""
        prompt = np.asarray(prompt_ids).reshape(-1)
        blocks = token_blocks(prompt, self._pl)
        n = len(blocks)
        got = int(k_stacks[0].shape[0]) if len(k_stacks) else 0
        if got != n:
            raise BadRequest(
                f"{got} shipped pages != {n} full prompt blocks")

        def _install():
            trie = self._pool.trie
            if trie is None:
                raise BadRequest("prefix cache disabled: cannot install")
            if n == 0:
                return 0
            pages = self._pool.allocate(n)
            try:
                self._pool.write_pages(pages, k_stacks, v_stacks)
                adopted = trie.insert(blocks, pages, self._pool.allocator)
            finally:
                # the trie holds its own refs on adopted pages; ours drop
                # (unadopted duplicates free harmlessly here)
                for pg in pages:
                    self._pool.allocator.release(pg)
            return adopted

        out = self._run_on_worker(_install)
        self.metrics.inc("kv_installs")
        self.metrics.inc("kv_pages_installed", out)
        return out

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
            # cross-thread ops (KV export/install) land at the step
            # boundary, before admission — an installed prefix is visible
            # to the very next admit
            self._drain_ops()
            # a staged weight swap lands at the first zero-active boundary
            # (admission pauses below until it does)
            if self._pending_swap is not None and not self._active():
                self._apply_swap()
            # admit queued prompts into free slots (join mid-flight,
            # earliest deadline first, bounded by KV page headroom)
            while self._pending_swap is None:
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
                        pend, self._pending_swap = self._pending_swap, None
                        if pend is not None and not pend[2].done():
                            pend[2].set_exception(
                                EngineClosed("engine closed"))
                        while self._ops:
                            _fn, fut = self._ops.popleft()
                            if not fut.done():
                                fut.set_exception(
                                    EngineClosed("engine closed"))
                        return
                    if not self._queue and not self._ops and \
                            self._pending_swap is None:
                        self._cond.wait()  # submit/close/op notify
                continue
            try:
                self._decode_once(active)
            except Exception as e:  # decode fault: fail the in-flight batch
                now = time.monotonic()
                for i in active:
                    s = self._slots[i]
                    if s.req is not None and not s.req.future.done():
                        s.req.future.set_exception(e)
                    self._release_slot(i, now)
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
            if self._pool.warm is not None:
                # warm tier: restore spilled pages of this chain before
                # matching, so an evicted prefix costs a host dequantize
                # instead of a re-prefill
                self._pool.warm_restore(req.blocks[: (p - 1) // pl])
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
        # the draft prefills the WHOLE prompt through its own forward (its
        # dense slot arena has no prefix cache)
        if self.spec_k:
            self._draft_prefill(slot_no, req.prompt)
            self.metrics.inc("draft_prefills")
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
        t1 = time.monotonic()
        self.metrics.inc("prefill_ms_total", (t1 - t0) * 1e3)
        s.req = req
        s.length = p
        s.last_token = first
        s.t0 = t1  # slot residency opens (occupancy track)
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

    def _draft_prefill(self, slot_no: int, prompt: np.ndarray):
        """Land the draft model's K/V for the whole prompt in its slot
        arena (the draft proposes from position ``len(prompt)`` on), through
        the draft's own cached forward: its attention is the flash kernel.
        Positions past the prompt hold the padding's K/V until the draft's
        decode steps overwrite them, before any read."""
        p = len(prompt)
        bucket = self._prefill_bucket(p)
        padded = torch.zeros((1, bucket), dtype=torch.int64)
        padded[0, :p] = torch.from_numpy(np.asarray(prompt, dtype=np.int64))
        with torch.no_grad():
            _h, caches = self._draft.gpt(padded.to(self.device),
                                         use_cache=True)
        for li, (k, v) in enumerate(caches):
            self._dk[li][slot_no, :bucket] = k[0]
            self._dv[li][slot_no, :bucket] = v[0]

    def _propose(self, tokens: np.ndarray, lengths: np.ndarray, k: int):
        """k dense draft decode steps over every slot; fills columns 1..k
        of ``tokens`` with the proposals (one copy to the host)."""
        dev = self.device
        cur = torch.from_numpy(tokens[:, 0].copy()).to(dev)
        lens = torch.from_numpy(lengths).to(dev)
        props = []
        for j in range(k):
            cur = self._draft_step(self._dparams, self._dk, self._dv, cur,
                                   lens + j)
            props.append(cur)
        tokens[:, 1:k + 1] = torch.stack(props, dim=1).cpu().numpy()

    def _decode_once(self, active: List[int]):
        """One decode round. Without a draft model this is the classic W = 1
        step (one token per active slot). With one, the draft proposes
        ``k`` tokens per slot (k dense decode steps), the target scores all
        k + 1 window positions in ONE verify call, and each slot advances by
        its accepted run plus the target's own next token — emitted tokens
        are target argmaxes, so greedy output is unchanged."""
        S, B = self.config.max_slots, self._n_blocks
        k = self.spec_k if self._spec_on else 0
        W = k + 1
        tokens = np.zeros((S, W), dtype=np.int32)
        lengths = np.zeros(S, dtype=np.int32)
        tables = np.zeros((S, B), dtype=np.int32)
        for i in active:
            s = self._slots[i]
            tokens[i, 0] = s.last_token
            lengths[i] = min(s.length, self.max_len - 1)
            tables[i] = s.table
        # chaos site: scripted decode fault at an exact decode-round index
        # (PT_FAULTS="decode_fault@step=2") — the in-flight requests fail,
        # their slots release, queued prompts keep being admitted
        self._decode_no = getattr(self, "_decode_no", -1) + 1
        _injector().check("decode_fault", engine=self.name,
                          step=self._decode_no)
        t0 = time.monotonic()
        if k:
            self._propose(tokens, lengths, k)
        n, lpn = self._run_window(tables, tokens, lengths)
        self.metrics.inc("decode_ms_total", (time.monotonic() - t0) * 1e3)
        self.metrics.inc("decode_steps")
        self.metrics.inc("slot_rounds", len(active))
        self.metrics.observe_occupancy(len(active) / S)
        emitted_total = 0
        for i in active:
            s = self._slots[i]
            if k:
                a = greedy_accept(tokens[i, 1:k + 1], n[i, :k])
                # cap the advance at k so the draft cache stays in sync
                # (the all-accepted bonus would outrun what the draft saw)
                adv = min(a + 1, k)
                emit = [int(tokens[i, j + 1]) for j in range(adv - 1)]
                emit.append(int(n[i, adv - 1]))
                self.metrics.inc("spec_proposed", k)
                self.metrics.inc("spec_accepted", adv - 1)
            else:
                emit = [int(n[i, 0])]
            # every emitted token e IS the target argmax at window position
            # e (greedy_accept admits a draft token only when it equals
            # n[i, e]), so lpn[i, e] is its behavior logprob
            for e, t in enumerate(emit):
                s.length += 1
                s.last_token = t
                self._note_token(s.req, t, lpn[i, e])
                emitted_total += 1
                if self._emit_finish_check(i):
                    break
        self.metrics.inc("tokens_total", emitted_total)
        if k:
            self.metrics.inc("spec_rounds")

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
        now = time.monotonic()
        self.metrics.observe_latency((now - req.t_submit) * 1e3)
        self.metrics.inc("responses_total")
        self.metrics.mark_done()
        self._release_slot(slot_no, now)
        return True

    def _release_pages(self, s: _Slot) -> None:
        """Drop this slot's page refs (pages the trie adopted survive on
        its ref and stay reusable)."""
        for bi in range(s.blocks):
            self._pool.allocator.release(int(s.table[bi]))
        s.table[:] = 0
        s.blocks = s.shared = 0

    def _release_slot(self, slot_no: int, now: float) -> None:
        """Close the residency (a row of the occupancy history) and give
        the KV pages back to the pool."""
        s = self._slots[slot_no]
        if s.req is not None:
            t0 = s.t0 or now
            self._slot_hist.append((slot_no, t0, now, len(s.req.generated)))
            self._residencies += 1
        self._release_pages(s)
        s.req = None
        s.length = 0
        s.last_token = 0
        s.t0 = 0.0

    # -- observability --------------------------------------------------------
    def slot_occupancy(self, window_s: float = 60.0) -> Dict[str, Any]:
        """Per-slot busy fraction over the recent window (history + live
        residencies)."""
        now = time.monotonic()
        horizon = max(now - window_s, self._t_start)
        span = max(now - horizon, 1e-6)
        busy = {i: 0.0 for i in range(self.config.max_slots)}
        for slot, t0, t1, _tokens in list(self._slot_hist):
            lo, hi = max(t0, horizon), min(t1, now)
            if hi > lo:
                busy[slot] = busy.get(slot, 0.0) + (hi - lo)
        for i, s in enumerate(self._slots):
            if s.req is not None and s.t0:
                busy[i] = busy.get(i, 0.0) + (now - max(s.t0, horizon))
        return {
            "slots": self.config.max_slots,
            "active": len(self._active()),
            "busy_frac": {str(i): round(min(b / span, 1.0), 4)
                          for i, b in busy.items()},
            "residencies": self._residencies,
            "window_s": round(span, 1),
        }

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
        if self.spec_k:
            prop = c.get("spec_proposed", 0)
            snap["spec_acceptance"] = round(
                c.get("spec_accepted", 0) / prop, 4) if prop else 0.0
        snap["spec_enabled"] = self.speculative_enabled()
        return snap

"""Speculative decoding primitives (Leviathan et al. / Chen et al.); a
copy of ``paddle_tpu/serving/speculative.py``.

The engine's speculative path is greedy: the draft proposes, the target
scores every proposal in one window-step call, and the accepted run plus
the target's own next token is emitted — each emitted token is a target
argmax, so greedy output is token-for-token the non-speculative path.

``rejection_sample`` is the *sampled* counterpart, standalone and
framework-free: standard rejection sampling over draft vs target
distributions, which keeps the OUTPUT DISTRIBUTION exactly the target's
for any draft. It operates on numpy probability rows.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["rejection_sample", "greedy_accept"]


def greedy_accept(draft_tokens, target_argmax) -> int:
    """Length of the accepted draft run under GREEDY verification: draft
    token ``i`` survives iff it equals the target's argmax after the
    previous position (``target_argmax[i]``) and every earlier draft
    survived."""
    a = 0
    k = len(draft_tokens)
    while a < k and int(draft_tokens[a]) == int(target_argmax[a]):
        a += 1
    return a


def rejection_sample(draft_probs: np.ndarray, target_probs: np.ndarray,
                     draft_tokens: np.ndarray,
                     rng: Optional[np.random.RandomState] = None
                     ) -> Tuple[np.ndarray, int]:
    """Standard speculative rejection sampling.

    ``draft_probs[i]``/``target_probs[i]`` are the draft's and target's
    next-token distributions at proposal position ``i`` (``i < k``);
    ``target_probs[k]`` is the target's distribution after the full draft
    run (the bonus position). ``draft_tokens[i]`` was sampled from
    ``draft_probs[i]``.

    Draft token ``i`` is accepted with probability
    ``min(1, p_target(x_i) / p_draft(x_i))``; on the first rejection the
    replacement is sampled from ``normalize(max(p_target - p_draft, 0))``
    — the residual that makes the OUTPUT distribution exactly the
    target's. If every draft survives, one bonus token is sampled from
    ``target_probs[k]``.

    Returns ``(emitted_tokens, num_accepted)`` — ``len(emitted) ==
    num_accepted + 1`` always (the standard +1 advance per round).
    """
    rng = rng or np.random.RandomState()
    k = len(draft_tokens)
    assert draft_probs.shape[0] >= k and target_probs.shape[0] >= k + 1
    out = []
    for i in range(k):
        x = int(draft_tokens[i])
        p_t = float(target_probs[i, x])
        p_d = float(draft_probs[i, x])
        if p_d <= 0.0 or rng.uniform() < min(1.0, p_t / p_d):
            out.append(x)
            continue
        # rejected: sample the residual (target minus draft, clipped)
        resid = np.maximum(target_probs[i] - draft_probs[i], 0.0)
        z = resid.sum()
        if z <= 0.0:  # identical distributions: the draft token was fine
            out.append(x)
            continue
        out.append(int(rng.choice(len(resid), p=resid / z)))
        return np.asarray(out, dtype=np.int64), i
    bonus = target_probs[k]
    out.append(int(rng.choice(len(bonus), p=bonus / bonus.sum())))
    return np.asarray(out, dtype=np.int64), k

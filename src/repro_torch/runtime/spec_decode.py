"""Draft proposers and greedy acceptance for speculative decoding — the
port of ``repro/runtime/spec_decode.py``.

The serve loop's draft-then-verify step comes in three parts:

  1. a cheap host-side draft proposer (this module) guesses k-1 tokens
     continuing the committed stream;
  2. one chunked-prefill-shaped verify pass (``model.verify_step``) scores
     [cur, d_1, .., d_{k-1}] against the paged pool in a single launch a
     layer;
  3. greedy acceptance (:func:`accept_greedy`) keeps the longest prefix of
     drafts that match the model's own argmax chain, and the scheduler
     rewinds the rejected tail with ``BlockPool.truncate(...,
     free_blocks=False)``.

Greedy acceptance makes any proposer output-safe: a bad draft costs wasted
verify columns, never a wrong token.  :func:`ngram_propose` and
:func:`accept_greedy` are host-side numpy, as in the reference;
:class:`HeadDraft` builds its next-token table on the parameters' device,
in row blocks (the reference forms E·Eᵀ whole, which at a vocabulary of
129,280 is about 67 GB), and chains it on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import no_tf32

DRAFT_KINDS = ("ngram", "head")


def ngram_propose(history, k: int, max_n: int = 4) -> list:
    """Propose ``k`` tokens continuing ``history`` by longest-suffix n-gram
    match: for n = max_n..1, find the most recent earlier occurrence of the
    length-n suffix and propose the tokens that followed it, padded with
    its last token where the continuation runs into the suffix.  Falls back
    to repeating the last token."""
    h = np.asarray(history, dtype=np.int64).ravel()
    L = int(h.size)
    assert L >= 1 and k >= 1
    for n in range(min(max_n, L - 1), 0, -1):
        suf = h[L - n:]
        # windows[i] == h[i:i+n]; candidate starts exclude the suffix itself
        windows = np.lib.stride_tricks.sliding_window_view(h, n)[: L - n]
        hits = np.nonzero((windows == suf[None, :]).all(axis=1))[0]
        if hits.size:
            j = int(hits[-1]) + n             # continuation of latest match
            cont = h[j: j + k]
            if cont.size:
                out = cont.tolist()
                while len(out) < k:           # match ran into the suffix
                    out.append(out[-1])
                return [int(t) for t in out]
    return [int(h[-1])] * k


def head_table(embed, block: int = 2048):
    """The head drafter's next-token table, ``table[t] = argmax_{t' != t}
    E[t] · E[t']``, computed on ``embed``'s device in fp32 (TF32 off), in
    blocks of ``block`` rows: a block's similarities [block, V] are one
    product, their diagonal set to -inf, and each row's argmax taken with
    ties to the lowest index (``np.argmax``'s rule).  Each row is its own
    reduction, so the block size does not enter the table; every block is
    padded to ``block`` rows, so that each product has the same shape.
    Returns a host int64 array [V]."""
    e = embed.float()
    V = e.shape[0]
    out = torch.empty(V, dtype=torch.int64, device=e.device)
    with no_tf32():
        for lo in range(0, V, block):
            hi = min(lo + block, V)
            rows = e[lo:hi]
            if hi - lo < block:
                rows = torch.nn.functional.pad(rows,
                                               (0, 0, 0, block - (hi - lo)))
            sim = (rows @ e.T)[: hi - lo]
            idx = torch.arange(lo, hi, device=e.device)
            sim[idx - lo, idx] = float("-inf")   # a real chain, not t again
            out[lo:hi] = torch.argmax(sim, dim=1)
    return out.cpu().numpy()


class HeadDraft:
    """Self-draft "head" proposer: a greedy next-token table from embedding
    similarity (:func:`head_table`), chained k times on the host.  It is
    the shape of a learned draft head (one product a token, no KV cache);
    fp8 pools are refused for it at the command line, as in the
    reference."""

    def __init__(self, embed, block: int = 2048):
        self.table = head_table(torch.as_tensor(embed), block)

    def propose(self, history, k: int, **_) -> list:
        t = int(np.asarray(history).ravel()[-1])
        out = []
        for _ in range(k):
            t = int(self.table[t])
            out.append(t)
        return out


def make_drafter(kind: str, params, *, metrics=None):
    """Proposer factory for the serve loop: ``propose(history, k) -> [k]``.
    ``params``: the model's parameters (the head drafter reads the fp32
    embedding table ``embed_f32`` where it is there, else ``embed``; ngram
    needs nothing).  With a ``metrics`` registry the proposer counts its
    calls and records its proposal lengths (``spec/draft_calls`` /
    ``spec/draft_len``); the proposals are untouched."""
    if kind == "ngram":
        fn = ngram_propose
    elif kind == "head":
        fn = HeadDraft(params.get("embed_f32", params["embed"])).propose
    else:
        raise ValueError(
            f"unknown draft kind {kind!r} (want one of {DRAFT_KINDS})")
    if metrics is None:
        return fn
    calls = metrics.counter("spec/draft_calls")
    lens = metrics.histogram("spec/draft_len")

    def counted(history, k, **kw):
        out = fn(history, k, **kw)
        calls.inc()
        lens.record(len(out))
        return out
    return counted


def accept_greedy(drafts, preds) -> tuple:
    """Greedy acceptance.  ``drafts``: the k-1 proposed tokens d_1..d_{k-1};
    ``preds``: the k verify-pass argmaxes n_0..n_{k-1}, n_i the model's
    greedy next token after verify row i (row 0 is the committed token).
    Draft d_{i+1} is accepted iff it equals n_i and every earlier draft was
    accepted (a later match after a miss was scored against a wrong
    context).  Returns ``(accepted, next_token)``: the accepted draft count
    and the model's continuation after the last accepted row — the tokens
    one-at-a-time greedy decode would have produced."""
    preds = [int(p) for p in np.asarray(preds).ravel()]
    a = 0
    for d in drafts:
        if int(d) == preds[a]:
            a += 1
        else:
            break
    return a, preds[a]

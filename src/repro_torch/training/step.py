"""Serving step factories: one greedy decode step, the K-token macro-step,
and the batched group prefill.

The reference runs each as one jitted program (``lax.scan`` inside).  Here
they are eager loops with the same semantics, and everything the host does
not need stays on the device: argmax, EOS masking, the budget countdown,
the ``merge_decode_state`` freeze of masked slots, per-row true-length
position advance and first-token capture.  No ``.item()``, ``.cpu()`` or
``.tolist()`` runs inside a loop; the caller syncs once on the result.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model import Model


def make_serve_step(model: Model) -> Callable:
    """One lockstep decode step: greedy next token + updated caches."""

    def serve_fn(params, decode_state, batch):
        logits, new_state = model.decode_step(params, decode_state, batch)
        return torch.argmax(logits[:, -1], dim=-1), new_state

    return serve_fn


def make_decode_macro_step(model: Model, horizon: int, *, eos_id: int,
                           pad_id: int) -> Callable:
    """K lockstep greedy decode steps per host consultation.

    Returns ``macro_fn(params, state, tok, active, budget) -> (emitted (B,
    K), new_state)``: ``tok`` is each slot's last token, ``active`` the live
    slot mask and ``budget`` the per-slot remaining token allowance, all
    device tensors.  A slot that emits ``eos_id`` or exhausts its budget is
    masked for the rest of the macro-step (state frozen, emissions padded
    with ``pad_id``); an active slot's EOS is emitted, then it goes quiet.
    """
    k_steps = max(int(horizon), 1)

    def macro_fn(params, state, tok, active, budget):
        st, tk, act, bud = state, tok, active, budget
        emitted = []
        for _ in range(k_steps):
            feed = torch.where(act, tk, pad_id)[:, None]
            logits, new_st = model.decode_step(params, st, {"tokens": feed})
            new_st = model.merge_decode_state(new_st, st, act)
            nxt = torch.argmax(logits[:, -1], dim=-1)
            emitted.append(torch.where(act, nxt, pad_id))
            bud = bud - act.long()
            new_act = act & (nxt != eos_id) & (bud > 0)
            st, tk, act = new_st, torch.where(act, nxt, tk), new_act
        return torch.stack(emitted, dim=1), st

    return macro_fn


def make_batched_prefill(model: Model) -> Callable:
    """Lower a whole padded prompt group into a per-slot decode state:
    a loop over fixed-width chunks through the same ``decode_step`` forward
    the decode path runs, with per-slot activity masks (slots not being
    prefilled stay frozen), per-row TRUE-length position advance for ragged
    groups, and on-device capture of each row's first generated token at
    its own last prompt position.  Pad garbage lands only at cache
    positions beyond each row's advance limit, where the causal
    ``decode_attention`` mask never reads it before a real write.

    ``prefill_fn(params, state, chunks, lengths) -> (first_tok (B,),
    state)`` with ``chunks`` (n_chunks, B, c) padded prompt chunks and
    ``lengths`` (B,) true prompt lengths (0 marks a slot not prefilled).
    """

    def prefill_fn(params, state, chunks, lengths):
        n_chunks, b, c = chunks.shape
        st = state
        first = torch.zeros((b,), dtype=torch.int64, device=chunks.device)
        for i in range(n_chunks):
            off = i * c
            valid = torch.clamp(lengths - off, 0, c)  # true tokens this chunk
            act = valid > 0
            logits, new_st = model.decode_step(params, st,
                                               {"tokens": chunks[i]})
            new_st = model.merge_decode_state(new_st, st, act)
            # decode_step advanced active rows by the full chunk width;
            # ragged rows only consumed ``valid`` prompt tokens
            new_st["pos"] = torch.where(act, st["pos"] + valid, st["pos"])
            done_now = act & (lengths <= off + c)
            at = torch.clamp(valid - 1, min=0)[:, None, None]
            last = torch.gather(logits, 1,
                                at.expand(b, 1, logits.shape[-1]))[:, 0]
            first = torch.where(done_now, torch.argmax(last, dim=-1), first)
            st = new_st
        return first, st

    return prefill_fn

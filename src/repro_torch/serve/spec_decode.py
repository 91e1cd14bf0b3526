"""Self-speculative decoding: a cheap-precision draft, a target-precision
verify (port of ``repro/serve/spec_decode.py``).

One round for a group of same-``(w_bits, draft_bits, kv_bits)`` requests is
one call of :func:`spec_decode_round`:

  1. **Draft**: ``spec_k`` single-token steps at ``draft_bits``
     (``serve/decode.py::paged_decode_step``, paged decode on the card),
     chained on the device: each step's token is a tensor that feeds the
     next, and nothing is read back to the host inside the round.  Draft
     tokens are drawn from the draft model's sampling distribution
     (``ops.sampling_probs``; the argmax for greedy rows), and each step's
     K/V goes into the request's pages, since draft step ``i + 1`` attends
     to drafts ``1..i``.
  2. **Verify**: the window ``[last token, d_1, .., d_k]`` runs one
     multi-token pass at the target ``w_bits`` through the paged prefill
     kernel (``ops.paged_mqa_verify``: a verify window is a causal
     self-chunk), giving target logits at every window position.  It
     attends only to the round-start cache and the window, and its K/V
     overwrites the drafts'.
  3. **Accept**: speculative rejection sampling (:func:`rejection_sample`):
     draft ``d_i`` is accepted with probability ``min(1, p_tgt / p_draft)``;
     the first reject is resampled from the normalized residual
     ``max(p_tgt - p_draft, 0)``, and when every draft survives the verify's
     own next token rides along (the bonus).  For greedy rows every
     distribution is a one-hot and the rule is exact token equality, so
     spec-on greedy streams equal spec-off ones.

Every draw is keyed by ``(seed, position, salt)`` (``ops.sample_keys``), so
a round is reproducible under a fixed seed whatever the batch.  The engine
then advances ``cache_len`` by the emitted count and rolls rejected tail
pages back with ``PagedKVCache.truncate``.  Under the tensor-parallel
mapping the drafts and the verify take the splits of ``serve/decode.py``,
and every rank draws from the same gathered logits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops, prng
from repro_torch.models import transformer as model_lib
from repro_torch.serve.decode import paged_decode_step
from repro_torch.serve.prefill import chunk_forward

# Salts of the independent draws one emission position needs.  SALT_EMIT is
# the plain decode/prefill emission salt (sample_keys' default), so a window
# that degenerates to the bonus slot draws what a plain decode step would.
SALT_EMIT = 0
SALT_DRAFT = 1
SALT_ACCEPT = 2
SALT_RESAMPLE = 3


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` per row b."""
    return x[torch.arange(x.shape[0], device=x.device), idx.long()]


def rejection_sample(
    drafts: torch.Tensor,  # [B, K] int — draft tokens per window slot
    q_draft: torch.Tensor,  # [B, K, V] draft sampling distributions
    q_target: torch.Tensor,  # [B, K+1, V] target sampling distributions
    seeds: torch.Tensor,  # [B] per-request seeds
    pos0: torch.Tensor,  # [B] stream position of each row's window slot 0
    n_draft: torch.Tensor,  # [B] int — live draft slots per row (<= K)
):
    """Speculative rejection sampling over one verify window.

    Returns ``(tokens [B, K+1] int32, accept [B])``: row b emits
    ``tokens[b, : accept[b] + 1]``, its accepted drafts and then either the
    residual resample at the first rejected slot or, when all ``n_draft[b]``
    drafts survive, the bonus token from the target's next-token
    distribution."""
    b, k = drafts.shape
    dev = drafts.device
    slots = torch.arange(k, device=dev)
    pos = pos0.long()[:, None] + slots[None, :]  # [B, K]
    drafts = drafts.long()
    n_draft = n_draft.long()

    def flat_keys(salt):  # one key per (row, slot)
        return ops.sample_keys(seeds[:, None].expand(b, k).reshape(-1), pos.reshape(-1), salt)

    p_t = torch.gather(q_target[:, :k], 2, drafts[..., None])[..., 0]
    p_d = torch.gather(q_draft, 2, drafts[..., None])[..., 0]
    if k:
        u = prng.uniform(flat_keys(SALT_ACCEPT)).reshape(b, k)
    else:
        u = torch.zeros(b, 0, device=dev)
    in_window = slots[None, :] < n_draft[:, None]
    ok = (u < p_t / torch.clamp_min(p_d, 1e-20)) & in_window
    accept = torch.cumprod(ok.long(), dim=1).sum(dim=1)

    # the residual resample at every slot (only the first rejected one is
    # used; each is its own position-keyed draw)
    if k:
        resid = torch.clamp_min(q_target[:, :k] - q_draft, 0.0)
        rs = resid.sum(dim=-1, keepdim=True)
        resid = torch.where(rs > 0, resid / torch.clamp_min(rs, 1e-20), q_target[:, :k])
        res_tok = ops.sample_from_probs(
            resid.reshape(b * k, -1), flat_keys(SALT_RESAMPLE)).reshape(b, k)
    else:
        res_tok = torch.zeros(b, 0, dtype=torch.int32, device=dev)

    # the bonus: every draft survived, the target's own next token, drawn at
    # position pos0 + n_draft with the plain emission salt
    bonus = ops.sample_from_probs(
        _at(q_target, n_draft), ops.sample_keys(seeds, pos0.long() + n_draft, SALT_EMIT))
    cut = _at(res_tok, torch.clamp(accept, 0, k - 1)) if k else bonus
    final = torch.where(accept >= n_draft, bonus, cut)

    slots1 = torch.arange(k + 1, device=dev)[None, :]
    drafts_pad = torch.nn.functional.pad(drafts, (0, 1))
    tokens = torch.where(
        slots1 < accept[:, None],
        drafts_pad,
        torch.where(slots1 == accept[:, None], final[:, None].long(), 0),
    ).to(torch.int32)
    return tokens, accept


def spec_decode_round(
    draft_params,  # param tree quantized at draft_bits
    params,  # param tree at the group's target w_bits
    tokens: torch.Tensor,  # [B, 1] int — last emitted token per request
    lengths: torch.Tensor,  # [B] int32 — tokens already in the cache
    tables: torch.Tensor,  # [B, W] int32 page tables (zero-padded)
    valid: torch.Tensor,  # [B] bool — False for pow2-bucket padding rows
    n_draft: torch.Tensor,  # [B] int32 — draft tokens this row runs (<= spec_k)
    samp,  # (temperature, top_k, top_p, seed, position), each [B], or None
    pool_k: torch.Tensor,  # [L, P, ps, Hkv, Dk]
    pool_v: torch.Tensor,
    pool_ks,  # [L, P, ps, Hkv, 1] f32 or None (kv_bits == 16)
    pool_vs,
    *,
    cfg: ArchConfig,
    spec_k: int,
):
    """One draft + verify + accept round.

    Returns ``(emit_tokens [B, spec_k+1] int32, accept [B], pools)``: row b
    emits ``emit_tokens[b, : accept[b] + 1]`` (``accept[b] <= n_draft[b]``).
    ``samp is None`` (an all-greedy group) drafts by argmax and accepts on
    token equality, with no vocabulary-sized probability algebra.  Every
    row's table must cover positions ``[0, lengths[b] + n_draft[b] + 1)``
    (the engine's ``_ensure_page_room`` and ``plan_windows`` see to it)."""
    pools = (pool_k, pool_v, pool_ks, pool_vs)
    b = tokens.shape[0]
    greedy = samp is None
    if not greedy:
        temps, top_ks, top_ps, seeds, pos0 = samp
    tok = tokens
    drafts, draft_probs = [], []
    # rows past their own n_draft keep computing but append nothing (the
    # step's valid mask), and their surplus drafts cannot be accepted
    for i in range(spec_k):
        logits, pools = paged_decode_step(
            draft_params, tok, lengths + i, tables, valid & (i < n_draft), *pools, cfg=cfg,
        )
        if greedy:
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        else:
            qd = ops.sampling_probs(logits, temps, top_ks, top_ps)
            tok = ops.sample_from_probs(
                qd, ops.sample_keys(seeds, pos0 + i, SALT_DRAFT))[:, None]
            draft_probs.append(qd)
        drafts.append(tok)
    wtok = torch.cat([tokens.to(torch.int32), *drafts], dim=1)  # [B, spec_k + 1]

    # verify: one causal self-chunk at the target precision from the
    # round-start lengths, so it never attends to draft K/V, and its K/V
    # overwrites the drafts'
    q_lens = torch.where(valid, n_draft + 1, 0).to(torch.int32)
    x, pools = chunk_forward(params, wtok, lengths, q_lens, tables, *pools, cfg=cfg,
                             verify=True)
    logits = model_lib.vocab_logits(x, params["unembed"], cfg)  # [B, C, V]

    if greedy:
        tgt = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, C]
        in_window = torch.arange(spec_k, device=tgt.device)[None, :] < n_draft[:, None]
        match = (wtok[:, 1:] == tgt[:, :-1]) & in_window
        accept = torch.cumprod(match.long(), dim=1).sum(dim=1)
        return tgt, accept, pools

    c = spec_k + 1

    def rep(a):  # each row's value for each of its c window slots
        return None if a is None else a[:, None].expand(b, c).reshape(-1)

    q_tgt = ops.sampling_probs(
        logits.reshape(b * c, -1), rep(temps), rep(top_ks), rep(top_ps)
    ).reshape(b, c, -1)
    q_draft = (torch.stack(draft_probs, dim=1) if spec_k
               else q_tgt.new_zeros(b, 0, q_tgt.shape[-1]))
    emit, accept = rejection_sample(wtok[:, 1:], q_draft, q_tgt, seeds, pos0, n_draft)
    return emit, accept, pools


def plan_windows(reqs, capacities: np.ndarray, spec_k: int) -> np.ndarray:
    """Per-row draft budget of one round: at most the request's own
    ``spec_k``, clipped so the round never emits past ``max_new_tokens``
    (the bonus token takes one slot) and never writes past the pages the
    pool granted (``_ensure_page_room`` shrinks the window under pressure
    rather than evict for speculation)."""
    n_draft = np.zeros(len(reqs), np.int32)
    for i, r in enumerate(reqs):
        remaining = r.max_new_tokens - len(r.out_tokens)
        room = int(capacities[i]) - r.cache_len - 1  # the window writes n_draft + 1
        n_draft[i] = max(0, min(r.spec_k, spec_k, remaining - 1, room))
    return n_draft


def clip_stop(req, emitted: list[int]) -> tuple[list[int], bool]:
    """Cut ``emitted`` after its first stop token (kept, as plain decode
    keeps it).  Returns (tokens, stopped)."""
    for j, tok in enumerate(emitted):
        if req.is_stop(tok):
            return emitted[: j + 1], True
    return emitted, False

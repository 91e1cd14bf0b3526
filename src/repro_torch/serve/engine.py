"""ServeEngine: continuous batching with per-request precision and
prefix-cache-aware chunked prefill (port of ``repro/serve/engine.py``).

One engine step:

  1. **Admit**: waiting requests are admitted FCFS while batch slots and KV
     pages last (head-of-line blocking, see scheduler.py).  Admission adopts
     the longest chain of cached full token blocks of the request's prompt
     read-only into its page table (prefix_cache.py), capped at
     ``prompt_len - 1`` so at least one token runs through the model; when
     that cap lands mid-page the shared page is copy-on-write forked.
  2. **Chunked prefill** (prefill.py): prefilling requests advance at most
     ``prefill_chunk`` tokens per step, grouped by (w_bits, kv_bits, pow2
     bucket of the remaining suffix) into one ragged ``chunk_prefill_step``
     call each; the call that completes a prompt yields the first token and
     registers the prompt's full blocks in the prefix cache.
  3. **Grow/evict**: a running request about to cross a page boundary gets
     one more page; if the pool is dry the prefix cache's LRU retained pages
     go first, then the youngest running request on that pool is preempted
     (its pages are released into the cache, so it usually resumes from
     cached pages).
  4. **Decode**: running requests are grouped by (w_bits, kv_bits); each
     group makes ONE ``paged_decode_step`` call, which also writes the new
     K/V token into its page.  Batch and table widths are pow2-bucketed.  A
     step that decodes >= 2 precision groups counts in
     ``stats.mixed_precision_steps``.

``submit(prompt, SamplingParams, PrecisionParams)`` enqueues a request;
``generate()`` streams one ``StreamEvent`` per emitted token plus a terminal
``GenerationOutput`` per request.  A request finishes on its token budget
(``"length"``) or the moment it emits its ``eos_id``/``stop_tokens``
(``"stop"``); one whose context can never fit its page pool is FAILED.

This slice serves greedy decoding of the dense family.  ``temperature >
0``, ``top_k``, ``top_p < 1``, ``spec_k > 0`` and archs with frontend prefix
embeddings (``prefix_len > 0``) raise ``NotImplementedError`` naming the
ROADMAP item.  There are no jits and no donation: PyTorch runs eagerly, and
the step functions update the pools in place.  The engine runs on the card
unless the caller asks for the CPU (``device="cpu"``, which runs every
kernel's plain version); with no card present the default raises.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as model_lib
from repro_torch.serve.decode import paged_decode_sample
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.outputs import (
    FINISH_FAILED,
    FINISH_LENGTH,
    FINISH_STOP,
    GenerationOutput,
    StreamEvent,
)
from repro_torch.serve.params import PrecisionParams, SamplingParams
from repro_torch.serve.prefill import bucket_pow2, chunk_prefill_sample
from repro_torch.serve.prefix_cache import PrefixCache, block_hashes
from repro_torch.serve.request import RequestState, ServeRequest
from repro_torch.serve.scheduler import Scheduler

_SUPPORTED_FAMILIES = ("dense",)


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``cuda`` unless the caller names another; a
    missing card raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available; pass device='cpu' to run the "
            "kernels' plain versions on the CPU"
        )
    return dev


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


@dataclass
class EngineStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    decode_steps: int = 0  # batched decode group calls
    engine_steps: int = 0
    tokens_out: int = 0
    prefills: int = 0  # completed request prefills
    prefill_chunks: int = 0  # chunk_prefill_step calls
    preemptions: int = 0
    mixed_precision_steps: int = 0  # engine steps decoding >= 2 precision groups
    occupancy_sum: int = 0  # sum of decode group sizes (mean = /decode_steps)
    spec_rounds: int = 0  # speculative rounds (always 0 in this slice)
    spec_draft_tokens: int = 0
    spec_accepted_tokens: int = 0
    failed: int = 0  # requests rejected at admission (context can't fit)
    group_calls: dict = field(default_factory=dict)  # (w_bits, kv_bits) -> calls
    prefix_hit_tokens: int = 0  # prompt tokens served from cached pages
    prefix_new_tokens: int = 0  # prompt tokens actually computed
    ttfts: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=4096)
    )  # submit -> first token, seconds
    decode_call_s: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=4096)
    )  # per decode-group call wall time, seconds

    @property
    def mean_batch_occupancy(self) -> float:
        return self.occupancy_sum / max(self.decode_steps, 1)

    @property
    def decode_tok_per_s(self) -> float:
        return self.tokens_out / max(self.decode_s, 1e-9)

    @property
    def spec_accept_rate(self) -> float:
        return self.spec_accepted_tokens / max(self.spec_draft_tokens, 1)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of admitted prefill tokens served from cached pages."""
        total = self.prefix_hit_tokens + self.prefix_new_tokens
        return self.prefix_hit_tokens / max(total, 1)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: {item})")


class ServeEngine:
    @staticmethod
    def supports(cfg: ArchConfig) -> bool:
        """The port's engine serves the dense family in this slice."""
        return cfg.family in _SUPPORTED_FAMILIES

    def __init__(
        self,
        cfg: ArchConfig,
        params,
        *,
        max_slots: int = 8,
        num_pages: Optional[int] = None,
        page_size: int = 16,
        prefill_chunk: int = 32,
        enable_prefix_cache: bool = True,
        spec_k: int = 0,
        device=None,
    ):
        if not self.supports(cfg):
            raise _not_ported(
                f"serving the {cfg.family!r} family ({cfg.name})", "the other families"
            )
        if cfg.prefix_len:
            raise _not_ported(
                "one-shot prefill of frontend prefix embeddings (prefix_len > 0)",
                "the other families",
            )
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k:
            raise _not_ported("speculative decoding (spec_k > 0)", "spec decode")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.page_size = page_size
        self.num_pages = num_pages if num_pages is not None else max_slots * 32
        self.prefill_chunk = prefill_chunk
        self._prefix_enabled = enable_prefix_cache
        self._sched = Scheduler(max_slots)
        # w_bits -> param tree (quantized lazily)
        self._params = {16: _to_device(params, self.device)}
        self._caches: dict[int, PagedKVCache] = {}  # kv_bits -> page pool
        self._prefix: dict[int, PrefixCache] = {}  # kv_bits -> prefix cache
        self._block_hashes: dict[int, list[bytes]] = {}  # rid -> prompt chain
        self._next_arrival = 0
        self._next_rid = 0
        self.finished: list[ServeRequest] = []
        self.stats = EngineStats()

    # -------------------------------------------------------------- plumbing
    def params_for(self, w_bits: int):
        if w_bits not in self._params:
            self._params[w_bits] = model_lib.quantize_params(self._params[16], w_bits)
        return self._params[w_bits]

    def cache_for(self, kv_bits: int) -> PagedKVCache:
        if kv_bits not in self._caches:
            self._caches[kv_bits] = PagedKVCache(
                self.cfg,
                num_pages=self.num_pages,
                page_size=self.page_size,
                kv_bits=kv_bits,
                device=self.device,
            )
            if self._prefix_enabled:
                self._prefix[kv_bits] = PrefixCache(self._caches[kv_bits])
        return self._caches[kv_bits]

    def _group_cfg(self, kv_bits: int) -> ArchConfig:
        return dataclasses.replace(self.cfg, serve_kv_bits=kv_bits)

    def _prefill_len(self, req: ServeRequest) -> int:
        return len(req.feed_tokens())

    def _max_ctx(self, req: ServeRequest) -> int:
        """Largest cache the request can ever need (the final emitted token
        is never fed back)."""
        return len(req.prompt) + req.max_new_tokens - 1

    def _prefilling(self, req: ServeRequest) -> bool:
        return req.cache_len < self._prefill_len(req)

    def _chain_salt(self, req: ServeRequest) -> tuple:
        # K/V values depend on the weight precision that computed them: W4
        # and W8 requests must never share pages even in the same kv pool
        return ("w", req.w_bits)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ---------------------------------------------------------------- submit
    def submit(
        self,
        prompt: np.ndarray,
        sampling: Optional[SamplingParams] = None,
        precision: Optional[PrecisionParams] = None,
        *,
        rid: Optional[int] = None,
    ) -> ServeRequest:
        """Enqueue one request: ``submit(prompt, SamplingParams(...),
        PrecisionParams(...))``.  Omitted params take the engine defaults
        (greedy, 16 tokens; the config's precisions)."""
        sampling = SamplingParams() if sampling is None else sampling
        precision = PrecisionParams() if precision is None else precision
        if sampling.temperature > 0.0 or sampling.top_k or sampling.top_p < 1.0:
            raise _not_ported("sampling (temperature / top_k / top_p)", "sampling")
        if precision.spec_k:
            raise _not_ported("speculative decoding (spec_k > 0)", "spec decode")
        w_bits = self.cfg.serve_w_bits if precision.w_bits is None else precision.w_bits
        kv_bits = (
            self.cfg.serve_kv_bits if precision.kv_bits is None else precision.kv_bits
        )
        if rid is not None:
            live = {r.rid for r in (*self._sched.waiting, *self._sched.running)}
            if rid in live:
                raise ValueError(f"rid {rid} is already in flight")
        req = ServeRequest(
            rid=self._next_rid if rid is None else rid,
            prompt=np.asarray(prompt, np.int32),
            max_new_tokens=sampling.max_new_tokens,
            w_bits=w_bits,
            kv_bits=kv_bits,
            eos_id=sampling.eos_id,
            stop_tokens=sampling.stop_tokens,
            seed=sampling.seed,
            arrival=self._next_arrival,
            submit_ts=time.perf_counter(),
        )
        self._next_rid = max(self._next_rid, req.rid + 1)
        self._next_arrival += 1
        cache = self.cache_for(kv_bits)
        if cache.pages_for(self._max_ctx(req)) > cache.num_pages:
            raise ValueError(
                f"request can never fit: prompt + max_new_tokens needs "
                f"{cache.pages_for(self._max_ctx(req))} pages; the kv{kv_bits} "
                f"pool only has {cache.num_pages}"
            )
        self._sched.submit(req)
        return req

    # ------------------------------------------------- admission (prefix-aware)
    def _fail(self, req: ServeRequest, msg: str) -> None:
        if req in self._sched.waiting:
            self._sched.waiting.remove(req)
        req.state = RequestState.FAILED
        req.error = msg
        req.finish_reason = FINISH_FAILED
        self._block_hashes.pop(req.rid, None)
        self.stats.failed += 1
        self.finished.append(req)

    def _admissible(self, req: ServeRequest) -> bool:
        cache = self.cache_for(req.kv_bits)
        need = cache.pages_for(self._max_ctx(req))
        if need <= cache.num_pages:
            return True
        self._fail(
            req,
            f"context can never fit: prompt + max_new_tokens needs {need} "
            f"pages; the kv{req.kv_bits} pool only has {cache.num_pages}",
        )
        return False

    def _try_admit(self, req: ServeRequest) -> bool:
        """Admission with commitment: on True the request holds its
        full-prompt page table (cached prefix blocks adopted shared, the
        divergence page CoW-forked, fresh pages for the uncached suffix)."""
        if not self._admissible(req):
            return False
        cache = self.cache_for(req.kv_bits)
        ps = cache.page_size
        plen = self._prefill_len(req)
        n_pages = cache.pages_for(plen)
        pc = self._prefix.get(req.kv_bits)
        hashes: list[bytes] = []
        pages: list[int] = []
        if pc is not None:
            # memoized across admission retries: a head-of-line request
            # blocked on a full pool is re-checked every engine step
            feed = req.feed_tokens()
            hashes = self._block_hashes.get(req.rid, [])
            if len(hashes) != len(feed) // ps:
                hashes = block_hashes(feed, ps, self._chain_salt(req))
                self._block_hashes[req.rid] = hashes
            pages = pc.match(hashes)
        # a full-prompt hit is capped so one suffix token produces the first
        # logits; if the pool can't afford a candidate, degrade the hit:
        # capped -> floored to a page multiple (no fork) -> cold
        best = min(len(pages) * ps, plen - 1)
        candidates = [best]
        if best % ps:
            candidates.append(best - best % ps)
        if candidates[-1] != 0:
            candidates.append(0)
        for hit in candidates:
            shared = pages[: -(-hit // ps)] if hit else []
            fork_needed = 1 if hit % ps else 0
            fresh_needed = n_pages - len(shared) + fork_needed
            reclaimable = max(0, cache.num_reclaimable - len(shared))
            if cache.num_free + reclaimable < fresh_needed:
                continue
            try:
                cache.allocate(req.rid, n_pages, prefix_pages=tuple(shared))
            except MemoryError:
                continue
            if pc is not None:
                pc.acquire_note(shared)
                if fork_needed:
                    try:
                        cache.fork_page(req.rid, hit // ps)
                    except MemoryError:
                        cache.free(req.rid)
                        continue
                    pc.stats.forks += 1
            req.cache_len = hit
            if pc is not None:
                pc.stats.lookups += 1
                pc.stats.lookup_tokens += len(hashes) * ps
                pc.stats.hit_tokens += hit
            self.stats.prefix_hit_tokens += hit
            self.stats.prefix_new_tokens += plen - hit
            return True
        return False

    # ------------------------------------------------------- chunked prefill
    def _prefill_pump(self) -> None:
        """Advance every prefilling request by at most one chunk."""
        pumping = [
            r
            for r in self._sched.running
            if r.state is RequestState.RUNNING and self._prefilling(r)
        ]
        if not pumping:
            return
        pumping.sort(key=lambda r: r.arrival)
        t0 = time.perf_counter()
        groups: dict[tuple, list[ServeRequest]] = {}
        for req in pumping:
            rem = self._prefill_len(req) - req.cache_len
            if rem <= self.prefill_chunk:
                # clamped: for a non-pow2 budget the pow2 bucket could exceed it
                key = (req.w_bits, req.kv_bits,
                       min(bucket_pow2(rem), self.prefill_chunk))
            else:  # long runners batch too: one ragged call per precision
                key = (req.w_bits, req.kv_bits, "long")
            groups.setdefault(key, []).append(req)
        for key, reqs in sorted(groups.items(), key=lambda kv: kv[1][0].arrival):
            chunk = self.prefill_chunk if key[2] == "long" else key[2]
            self._chunk_group(reqs, chunk)
        self.stats.prefill_s += time.perf_counter() - t0

    def _chunk_group(self, reqs: list[ServeRequest], chunk: int) -> None:
        w_bits, kv_bits = reqs[0].w_bits, reqs[0].kv_bits
        cache = self.cache_for(kv_bits)
        rids = [r.rid for r in reqs]
        n = len(reqs)
        bsz = bucket_pow2(n)  # padding rows have q_len 0 and write nothing
        tokens = np.zeros((bsz, chunk), np.int32)
        q_start = np.zeros(bsz, np.int32)
        q_lens = np.zeros(bsz, np.int32)
        for i, r in enumerate(reqs):
            feed = r.feed_tokens()
            q_start[i] = r.cache_len
            q_lens[i] = min(len(feed) - r.cache_len, chunk)
            tokens[i, : q_lens[i]] = feed[r.cache_len : r.cache_len + q_lens[i]]
        width = bucket_pow2(max(len(cache.table(r)) for r in rids))
        tables = np.zeros((bsz, width), np.int32)
        tables[:n] = cache.table_array(rids, width)
        first_tok, _ = chunk_prefill_sample(
            self.params_for(w_bits), self._tensor(tokens), self._tensor(q_start),
            self._tensor(q_lens), self._tensor(tables), None, *cache.pools,
            cfg=self._group_cfg(kv_bits),
        )
        first = first_tok.cpu().numpy()
        self.stats.prefill_chunks += 1
        for i, req in enumerate(reqs):
            req.cache_len += int(q_lens[i])
            if not self._prefilling(req):
                self._on_prefill_done(req, int(first[i]))

    def _on_prefill_done(self, req: ServeRequest, first_token: int) -> None:
        self.stats.prefills += 1
        if not req.out_tokens:  # fresh request: prefill yields token #1
            req.out_tokens.append(first_token)
            self.stats.tokens_out += 1
            req.ttft = time.perf_counter() - req.submit_ts
            self.stats.ttfts.append(req.ttft)
        self._register_blocks(req)
        if len(req.out_tokens) >= req.max_new_tokens or req.is_stop(req.out_tokens[-1]):
            self._finish(req)

    def _register_blocks(self, req: ServeRequest) -> None:
        pc = self._prefix.get(req.kv_bits)
        if pc is None or req.cache_len < pc.block:
            return
        cache = self.cache_for(req.kv_bits)
        feed = req.feed_tokens()[: req.cache_len]
        hashes = self._block_hashes.get(req.rid, [])
        n_blocks = len(feed) // pc.block
        if n_blocks > len(hashes):  # decode extended the chain past the prompt
            hashes = block_hashes(feed, pc.block, self._chain_salt(req))
            self._block_hashes[req.rid] = hashes
        pc.register(hashes[:n_blocks], cache.table(req.rid)[:n_blocks])

    # ---------------------------------------------------------------- decode
    def _ensure_page_room(self) -> None:
        """Grow page tables for requests crossing a page boundary; preempt
        youngest-first when a pool is dry (the allocation path evicts LRU
        prefix-cache pages before anyone is preempted)."""
        for req in sorted(self._sched.running, key=lambda r: r.arrival):
            if req.state is not RequestState.RUNNING:
                continue
            cache = self.cache_for(req.kv_bits)
            while req.cache_len + 1 > cache.capacity_tokens(req.rid):
                if cache.can_allocate(1):
                    cache.extend(req.rid, 1)
                    continue
                victim = self._sched.pick_victim(kv_bits=req.kv_bits)
                self._preempt(victim)
                if victim is req:
                    break

    def _release_pages(self, req: ServeRequest) -> None:
        self._register_blocks(req)
        self.cache_for(req.kv_bits).free(req.rid)
        self._block_hashes.pop(req.rid, None)

    def _preempt(self, req: ServeRequest) -> None:
        self._release_pages(req)
        self._sched.preempt(req)
        self.stats.preemptions += 1

    def _finish(self, req: ServeRequest) -> None:
        req.finish_reason = (
            FINISH_STOP
            if req.out_tokens and req.is_stop(req.out_tokens[-1])
            else FINISH_LENGTH
        )
        self._release_pages(req)
        self._sched.finish(req)
        self.finished.append(req)

    def _batch_arrays(self, cache: PagedKVCache, reqs: list[ServeRequest]):
        """pow2-bucketed (tokens, lengths, tables, valid) for a decode group;
        padding rows are masked so they never touch the pool."""
        rids = [r.rid for r in reqs]
        width = bucket_pow2(max(len(cache.table(r)) for r in rids))
        n_real = len(reqs)
        bsz = bucket_pow2(n_real)
        tables = np.zeros((bsz, width), np.int32)
        tables[:n_real] = cache.table_array(rids, width)
        tokens = np.zeros((bsz, 1), np.int32)
        tokens[:n_real, 0] = [r.out_tokens[-1] for r in reqs]
        lengths = np.zeros(bsz, np.int32)
        lengths[:n_real] = [r.cache_len for r in reqs]
        valid = np.arange(bsz) < n_real
        return tokens, lengths, tables, valid

    def _decode_groups(self) -> int:
        """One batched call per (w_bits, kv_bits) group; each emits one
        token per request."""
        plain: dict[tuple[int, int], list[ServeRequest]] = {}
        for req in self._sched.running:
            if (
                req.state is RequestState.RUNNING
                and req.out_tokens
                and not self._prefilling(req)
            ):
                plain.setdefault(req.group_key, []).append(req)
        t0 = time.perf_counter()
        for (w_bits, kv_bits), reqs in sorted(plain.items()):
            self._plain_decode_group(reqs, w_bits, kv_bits)
        self.stats.decode_s += time.perf_counter() - t0
        if len(plain) >= 2:
            self.stats.mixed_precision_steps += 1
        return len(plain)

    def _plain_decode_group(
        self, reqs: list[ServeRequest], w_bits: int, kv_bits: int
    ) -> None:
        reqs.sort(key=lambda r: r.arrival)
        cache = self.cache_for(kv_bits)
        n_real = len(reqs)
        tokens, lengths, tables, valid = self._batch_arrays(cache, reqs)
        t_call = time.perf_counter()
        sampled, _ = paged_decode_sample(
            self.params_for(w_bits), self._tensor(tokens), self._tensor(lengths),
            self._tensor(tables), self._tensor(valid), None, *cache.pools,
            cfg=self._group_cfg(kv_bits),
        )
        next_tok = sampled[:n_real].cpu().numpy()
        self.stats.decode_call_s.append(time.perf_counter() - t_call)
        for i, req in enumerate(reqs):
            req.cache_len += 1
            tok = int(next_tok[i])
            req.out_tokens.append(tok)
            self.stats.tokens_out += 1
            if req.is_stop(tok) or len(req.out_tokens) >= req.max_new_tokens:
                self._finish(req)
        self.stats.decode_steps += 1
        self.stats.occupancy_sum += len(reqs)
        key = (w_bits, kv_bits)
        self.stats.group_calls[key] = self.stats.group_calls.get(key, 0) + 1

    def step(self) -> bool:
        """One engine iteration; returns True if any work was done (failing
        an inadmissible request counts: it empties the queue)."""
        failed_before = self.stats.failed
        admitted = self._sched.admit(self._try_admit)
        pumping = any(
            r.state is RequestState.RUNNING and self._prefilling(r)
            for r in self._sched.running
        )
        self._prefill_pump()
        self._ensure_page_room()
        n_groups = self._decode_groups()
        self.stats.engine_steps += 1
        return bool(admitted) or pumping or n_groups > 0 or self.stats.failed > failed_before

    def _stalled(self) -> RuntimeError:
        free = {b: c.num_allocatable for b, c in self._caches.items()}
        return RuntimeError(f"engine stalled: no request can be admitted (free pages: {free})")

    def run(self) -> list[ServeRequest]:
        """Drive until every submitted request finishes or fails."""
        while self._sched.has_work():
            if not self.step():
                raise self._stalled()
        return self.finished

    def generate(
        self,
        requests: Optional[Iterable] = None,
    ) -> Iterator[Union[StreamEvent, GenerationOutput]]:
        """Streaming generation: drive the engine and yield one
        ``StreamEvent`` per emitted token, then each request's terminal
        ``GenerationOutput`` as it finishes.  ``requests`` may mix submitted
        ``ServeRequest`` handles with ``(prompt, sampling[, precision])``
        tuples or bare prompts; ``None`` streams everything enqueued."""
        if requests is None:
            track = [*self._sched.waiting, *self._sched.running]
        else:
            track = []
            for r in requests:
                if isinstance(r, ServeRequest):
                    track.append(r)
                elif isinstance(r, (tuple, list)):
                    track.append(self.submit(*r))
                else:
                    track.append(self.submit(r))
        streamed = {r.rid: 0 for r in track}
        pending = {r.rid for r in track}

        def drain(req: ServeRequest):
            terminal = req.done or req.failed
            while streamed[req.rid] < len(req.out_tokens):
                i = streamed[req.rid]
                streamed[req.rid] = i + 1
                last = terminal and streamed[req.rid] == len(req.out_tokens)
                yield StreamEvent(
                    rid=req.rid,
                    token=req.out_tokens[i],
                    index=i,
                    finish_reason=req.finish_reason if last else None,
                )
            if terminal:
                pending.discard(req.rid)
                yield GenerationOutput.from_request(req)

        for req in track:
            yield from drain(req)
        while pending:
            if not self.step():
                raise self._stalled()
            for req in track:
                if req.rid in pending:
                    yield from drain(req)

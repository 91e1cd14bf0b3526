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
     ``stats.mixed_precision_steps``.  Requests with ``spec_k > 0`` instead
     run speculative rounds (serve/spec_decode.py), grouped by (w_bits,
     draft_bits, kv_bits): up to ``spec_k`` drafts at the cheap
     ``draft_bits`` weight set, one verify of the window at ``w_bits``
     through the paged prefill kernel, rejection sampling (exact equality
     for greedy rows), then the rejected tail pages go back to the pool
     (``PagedKVCache.truncate``).

``submit(prompt, SamplingParams, PrecisionParams)`` enqueues a request;
``generate()`` streams one ``StreamEvent`` per emitted token plus a terminal
``GenerationOutput`` per request.  A request finishes on its token budget
(``"length"``) or the moment it emits its ``eos_id``/``stop_tokens``
(``"stop"``); one whose context can never fit its page pool is FAILED.

Every group call ends in the position-keyed sampler
(``kernels/ops.py::sample_tokens``): per-row temperature / top-k / top-p
with keys ``fold_in(PRNGKey(seed), position)``, so a sampled stream is
reproducible under a fixed seed whatever the batch composition, bucketing or
preemptions, and ``temperature == 0`` rows are the exact argmax.

The engine serves the dense, vlm, audio and moe families (an MoE layer's
experts run inside the same chunk / decode / spec steps, ``models/moe.py``);
as in JAX, an MoE model with leading dense blocks (``first_dense``) is
refused, since the engine keeps one uniform stack of layers over its page
pools.  Archs with frontend prefix embeddings (``prefix_len > 0``: the vlm
and audio archs) keep the JAX engine's one-shot prefill and no prefix cache,
since prefix embeddings are not token-addressable: admitted requests are
grouped by (w_bits, kv_bits, prefix + prompt length), and each group runs
``transformer.prefill`` once, eagerly, over the prefix of
``models/frontends.py`` and the prompt; its contiguous cache is scattered
into each request's pages in place (``PagedKVCache.write_prompt``), and the
first token is the argmax of its logits, or ``ops.sample_tokens`` under the
same keys as every other step.  Decode steps and spec rounds then run
through the captured steps as for every arch.
The JAX engine's deprecated flat-kwargs ``submit`` is not ported.  In place
of the JAX engine's jits, every group call (chunk prefill, plain decode,
spec round) runs through the engine's captured steps (``serve/graphs.py``):
on the card each fixed-shape step is captured once as a CUDA graph per key
(precision, pow2 batch bucket, pow2 table width, chunk, spec_k, sampling
structure) and replayed after; ``graphs.disable_capture()`` runs them
eagerly, as ``jax.disable_jit()`` does.  A call's integer inputs travel to
the card in one copy, its sampling parameters in another, and its results
come back in one read.  There is no donation: the step functions update the
pools in place.  The engine runs on the card unless the caller asks for the
CPU (``device="cpu"``, which runs every kernel's plain version, eagerly);
with no card present the default raises.

``ServeEngine(mesh=)``, a ``("data", "model")`` DeviceMesh with one process
per device (``launch/mesh.py``: NCCL on the card, gloo on the CPU), serves
every family of the engine under the tensor-parallel mapping, as the JAX
engine jits its steps over its mesh.  The weights are resharded once
(``reshard_state``), and each ``w_bits`` view is quantized from this rank's
blocks (``transformer.quantize_params(..., mesh=)``); each pool holds this
rank's kv heads (``PagedKVCache(mesh=)``).  Every group call runs under the
engine's own mapping, ``sharding.use_mesh(mesh)`` inside
``sharding.whole_batch()``: every rank computes every row of every group,
on its blocks of the weights and its kv heads (``serve/decode.py``), and
samples from the logits gathered over ``model``.  Rows stay whole because a
request's row moves between groups and positions from step to step, so a
rank's pool must hold every page of its kv heads; every rank runs the same
scheduler on the same tokens and returns the same streams.  The captured
steps' keys name the split.  The one-shot-prefill families (vlm, audio)
run their eager ``_prefill_group`` under the same mapping, so each pool
receives this rank's kv heads of the prompt; ``moe_dispatch="alltoall"``
takes no mesh (NotImplementedError), as the JAX engine takes none: its
rows are not split over ``data`` (it raises on a group the data axis does
not divide, and with no mesh).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.models import transformer as model_lib
from repro_torch.models.frontends import prefix_embeddings
from repro_torch.serve import graphs
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
from repro_torch.serve.spec_decode import clip_stop, plan_windows, spec_decode_round

_SUPPORTED_FAMILIES = ("dense", "vlm", "audio", "moe")


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
    spec_rounds: int = 0  # draft + verify group calls
    spec_draft_tokens: int = 0  # tokens drafted at draft_bits
    spec_accepted_tokens: int = 0  # drafts the verify accepted and emission used
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
        """Fraction of drafted tokens the target-precision verify accepted."""
        return self.spec_accepted_tokens / max(self.spec_draft_tokens, 1)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of admitted prefill tokens served from cached pages."""
        total = self.prefix_hit_tokens + self.prefix_new_tokens
        return self.prefix_hit_tokens / max(total, 1)


def _samp_views(dev, kind):
    """``samp`` of a step from the packed float64 [5, B] tensor of
    :meth:`ServeEngine._samp_host`: (temperature, top_k or None, top_p or
    None, seed, position), or None for an all-greedy group."""
    if dev is None:
        return None
    has_k, has_p = kind
    return (dev[0].float(), dev[1].long() if has_k else None,
            dev[2].float() if has_p else None, dev[3].long(), dev[4].long())


class ServeEngine:
    @staticmethod
    def supports(cfg: ArchConfig) -> bool:
        """The JAX engine's rule: one uniform stack of attention layers, so
        attention families only, and no leading dense MoE blocks."""
        return cfg.family in _SUPPORTED_FAMILIES and not (
            cfg.family == "moe" and cfg.first_dense
        )

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
        draft_bits: int = 4,
        device=None,
        mesh=None,
    ):
        if mesh is not None and cfg.moe_dispatch == "alltoall":
            raise NotImplementedError(
                "ServeEngine(mesh=) takes no moe_dispatch='alltoall', as the JAX package's "
                "paged engine takes none (its groups' rows are not split over the data "
                "axis); the static-wave Server(mesh=) and the mesh train step take it")
        if not self.supports(cfg):
            what = (f"{cfg.first_dense} leading dense MoE block(s)" if cfg.family == "moe"
                    else f"the {cfg.family!r} family")
            raise NotImplementedError(
                f"ServeEngine needs a uniform attention-cache stack: {cfg.name} has {what}; "
                "serve it through the static waves (train/server.py)")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if draft_bits not in (4, 8, 16):
            raise ValueError(f"draft_bits must be 4, 8 or 16, got {draft_bits}")
        self.spec_k = spec_k  # submit() default: 0 = plain decode
        self.draft_bits = draft_bits  # submit() default draft precision
        self.device = resolve_device(device)
        self.cfg = cfg
        self.page_size = page_size
        self.num_pages = num_pages if num_pages is not None else max_slots * 32
        self.prefill_chunk = prefill_chunk
        # frontend prefix embeddings are not token-addressable: those archs
        # keep the one-shot grouped prefill and no prefix cache
        self._legacy_prefill = bool(cfg.prefix_len)
        self._prefix_enabled = enable_prefix_cache and not self._legacy_prefill
        self._sched = Scheduler(max_slots)
        self.mesh = mesh
        params = _to_device(params, self.device)
        if mesh is not None:  # this rank's blocks (at world size 1, the tensors)
            from repro_torch.distributed.elastic import mesh_device, reshard_state

            if mesh_device(mesh).type != self.device.type:
                raise ValueError(f"the mesh computes on {mesh_device(mesh)}, the engine on "
                                 f"{self.device}")
            params = reshard_state(params, mesh)
        # w_bits -> param tree (quantized lazily)
        self._params = {16: params}
        self._caches: dict[int, PagedKVCache] = {}  # kv_bits -> page pool
        self._prefix: dict[int, PrefixCache] = {}  # kv_bits -> prefix cache
        self._block_hashes: dict[int, list[bytes]] = {}  # rid -> prompt chain
        self._next_arrival = 0
        self._next_rid = 0
        self.finished: list[ServeRequest] = []
        self.stats = EngineStats()
        self.graphs = graphs.StepGraphs(self.device)  # the captured group calls

    # -------------------------------------------------------------- plumbing
    def params_for(self, w_bits: int):
        if w_bits not in self._params:
            self._params[w_bits] = model_lib.quantize_params(self._params[16], w_bits,
                                                             self.mesh)
        return self._params[w_bits]

    def cache_for(self, kv_bits: int) -> PagedKVCache:
        if kv_bits not in self._caches:
            self._caches[kv_bits] = PagedKVCache(
                self.cfg,
                num_pages=self.num_pages,
                page_size=self.page_size,
                kv_bits=kv_bits,
                device=self.device,
                mesh=self.mesh,
            )
            if self._prefix_enabled:
                self._prefix[kv_bits] = PrefixCache(self._caches[kv_bits])
        return self._caches[kv_bits]

    def prefix_cache_for(self, kv_bits: int) -> Optional[PrefixCache]:
        """The prefix cache of the ``kv_bits`` pool (None where the engine
        keeps none)."""
        self.cache_for(kv_bits)
        return self._prefix.get(kv_bits)

    def _group_cfg(self, kv_bits: int) -> ArchConfig:
        return dataclasses.replace(self.cfg, serve_kv_bits=kv_bits)

    def _prefill_len(self, req: ServeRequest) -> int:
        return self.cfg.prefix_len + len(req.feed_tokens())

    def _max_ctx(self, req: ServeRequest) -> int:
        """Largest cache the request can ever need (the final emitted token
        is never fed back)."""
        return self.cfg.prefix_len + len(req.prompt) + req.max_new_tokens - 1

    def _prefilling(self, req: ServeRequest) -> bool:
        return req.cache_len < self._prefill_len(req)

    def _chain_salt(self, req: ServeRequest) -> tuple:
        # K/V values depend on the weight precision that computed them: W4
        # and W8 requests must never share pages even in the same kv pool
        return ("w", req.w_bits)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @contextlib.contextmanager
    def _mapping(self):
        """The engine's TP mapping, every row on every rank (the module
        note); nothing without a mesh."""
        if self.mesh is None:
            yield
            return
        with sharding.use_mesh(self.mesh), sharding.whole_batch():
            yield

    @property
    def split(self) -> Optional[tuple]:
        """How a group call splits, part of its captured step's key: None
        without a mesh, else the mapping, the mesh's axes and this rank's
        coordinate in it, and the rows (whole on every rank)."""
        if self.mesh is None:
            return None
        return ("tp", tuple(sharding.mesh_shape(self.mesh).items()),
                tuple(self.mesh.get_coordinate()), "whole_batch")

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
        (greedy, 16 tokens; the config's precisions, the engine's spec_k and
        draft_bits)."""
        sampling = SamplingParams() if sampling is None else sampling
        precision = PrecisionParams() if precision is None else precision
        spec_k = self.spec_k if precision.spec_k is None else precision.spec_k
        draft_bits = self.draft_bits if precision.draft_bits is None else precision.draft_bits
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
            spec_k=spec_k,
            draft_bits=draft_bits,
            temperature=sampling.temperature,
            top_k=sampling.top_k,
            top_p=sampling.top_p,
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

    def _samp_host(self, reqs: list[ServeRequest], bsz: int):
        """(host, kind) of a bucketed group call's sampling parameters:
        ``host`` is the float64 [5, B] array of per-row (temperature, top_k,
        top_p, seed, position), each value exact in it, and ``kind`` is
        (uses top_k, uses top_p); both None when the whole group is greedy
        (the bare argmax).  A stage no row uses is None in the step's
        ``samp`` (:func:`_samp_views`), so a temperature-only group never
        sorts the vocabulary; either way a row draws the same token.
        ``position`` is the request's next emission index, the key
        coordinate that makes streams independent of batch and preemption.
        Padding rows stay greedy."""
        if all(r.greedy for r in reqs):
            return None, None
        host = np.zeros((5, bsz), np.float64)
        host[2] = 1.0  # top_p disabled
        for i, r in enumerate(reqs):
            host[:, i] = (r.temperature, r.top_k, r.top_p, r.seed, len(r.out_tokens))
        return host, (any(r.top_k > 0 for r in reqs), any(r.top_p < 1.0 for r in reqs))

    def _group_call(self, step: str, kv_bits: int, static: tuple, arrays: list,
                    reqs: list[ServeRequest], body) -> torch.Tensor:
        """One group call through the captured steps: ``arrays`` (host int
        arrays, batch-bucketed) travel to the card in one copy, the sampling
        parameters in another, and ``body(*arrays as tensors, samp)`` is the
        step, returning one tensor.  ``static`` names the weight sets (and
        spec_k); the key adds the group's cfg, the arrays' shapes and the
        sampling structure and, on a mesh, the split (:attr:`split`)."""
        flat, shapes = graphs.pack(arrays)
        host, kind = self._samp_host(reqs, shapes[0][0])
        inputs = (self._tensor(flat), None if host is None else self._tensor(host))
        cfg = self._group_cfg(kv_bits)
        key = graphs.step_key(step, cfg, (*static, shapes, kind, self.split), inputs)

        def fn(ints, samp):
            return body(*graphs.unpack(ints, shapes), _samp_views(samp, kind))

        with self._mapping():
            return self.graphs.run(key, fn, inputs)

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
        params, pools, cfg = self.params_for(w_bits), cache.pools, self._group_cfg(kv_bits)

        def body(tables, tokens, q_start, q_lens, samp):
            return chunk_prefill_sample(params, tokens, q_start, q_lens, tables, samp, *pools,
                                        cfg=cfg)[0]

        first = self._group_call("chunk", kv_bits, (w_bits,),
                                 [tables, tokens, q_start, q_lens], reqs, body).cpu().numpy()
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

    # ------------------------------------------ one-shot prefill (prefix_len)
    def _admit_and_prefill(self) -> list[ServeRequest]:
        """Admit what fits (each request's prefix + prompt pages reserved
        this round) and prefill every admitted request, one call per (w_bits,
        kv_bits, length) group."""
        reserved: dict[int, int] = {}  # kv_bits -> pages spoken for this round

        def fits(req: ServeRequest) -> bool:
            if not self._admissible(req):
                return False
            cache = self.cache_for(req.kv_bits)
            need = cache.pages_for(self._prefill_len(req))
            if cache.num_free - reserved.get(req.kv_bits, 0) < need:
                return False
            reserved[req.kv_bits] = reserved.get(req.kv_bits, 0) + need
            return True

        admitted = self._sched.admit(fits)
        groups: dict[tuple, list[ServeRequest]] = {}
        for req in admitted:
            groups.setdefault((req.w_bits, req.kv_bits, self._prefill_len(req)), []).append(req)
        t0 = time.perf_counter()
        for (w_bits, kv_bits, plen), reqs in groups.items():
            self._prefill_group(reqs, w_bits, kv_bits, plen)
        self.stats.prefill_s += time.perf_counter() - t0
        return admitted

    def _prefill_group(self, reqs: list[ServeRequest], w_bits: int, kv_bits: int,
                       plen: int) -> None:
        """One eager ``transformer.prefill`` over the group's prefix
        embeddings and prompts, its cache rows written into each request's
        pages; the first token comes from its logits.  On a mesh it runs
        under the engine's mapping, as the group calls do: every rank draws
        the same prefix, computes every row on its blocks of the weights and
        its kv heads (the pool's ``kv_heads``: its block where the model
        axis divides them, else all of them) and samples from the logits
        gathered over ``model``."""
        cache = self.cache_for(kv_bits)
        max_len = cache.pages_for(plen) * self.page_size
        params = self.params_for(w_bits)
        batch = {"tokens": self._tensor(np.stack([r.feed_tokens() for r in reqs])),
                 "prefix_emb": prefix_embeddings(self.cfg, len(reqs), device=self.device)}
        host, kind = self._samp_host(reqs, len(reqs))
        samp = None if host is None else _samp_views(self._tensor(host), kind)
        with self._mapping():
            logits, kv = model_lib.prefill(params, batch, self._group_cfg(kv_bits), max_len)
            first = ops.sample_or_argmax(logits, samp).cpu().numpy()
        for i, req in enumerate(reqs):
            cache.allocate(req.rid, cache.pages_for(plen))
            if cache.quantized:
                cache.write_prompt(req.rid, kv["k"][:, i], kv["v"][:, i],
                                   kv["k_scale"][:, i], kv["v_scale"][:, i])
            else:
                cache.write_prompt(req.rid, kv["k"][:, i], kv["v"][:, i])
            req.cache_len = plen
            self._on_prefill_done(req, int(first[i]))

    # ---------------------------------------------------------------- decode
    def _step_need(self, req: ServeRequest) -> int:
        """Cache positions this step may write for ``req``: the speculative
        window (drafts and the verify's bonus slot) for a spec request, one
        token otherwise."""
        if req.spec_k and req.out_tokens and not self._prefilling(req):
            remaining = req.max_new_tokens - len(req.out_tokens)
            return min(req.spec_k, max(remaining - 1, 0)) + 1
        return 1

    def _ensure_page_room(self) -> None:
        """Grow page tables for requests crossing a page boundary; preempt
        youngest-first when a pool is dry (the allocation path evicts LRU
        prefix-cache pages before anyone is preempted).  A spec request asks
        for its whole window but shrinks it to one token under pressure
        before anyone is preempted: speculation never costs a batch-mate its
        pages."""
        for req in sorted(self._sched.running, key=lambda r: r.arrival):
            if req.state is not RequestState.RUNNING:
                continue
            cache = self.cache_for(req.kv_bits)
            need = self._step_need(req)
            while req.cache_len + need > cache.capacity_tokens(req.rid):
                if cache.can_allocate(1):
                    cache.extend(req.rid, 1)
                    continue
                if need > 1:
                    need = 1  # shrink the speculative window, keep decoding
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
        """One batched call per precision group: ``(w_bits, kv_bits)`` plain
        decode groups emit one token per request; ``(w_bits, draft_bits,
        kv_bits)`` speculative groups run one round each and emit
        1..spec_k+1 tokens per request."""
        plain: dict[tuple[int, int], list[ServeRequest]] = {}
        spec: dict[tuple[int, int, int], list[ServeRequest]] = {}
        for req in self._sched.running:
            if (
                req.state is RequestState.RUNNING
                and req.out_tokens
                and not self._prefilling(req)
            ):
                if req.spec_k > 0:
                    spec.setdefault(req.spec_group_key, []).append(req)
                else:
                    plain.setdefault(req.group_key, []).append(req)
        t0 = time.perf_counter()
        for (w_bits, kv_bits), reqs in sorted(plain.items()):
            self._plain_decode_group(reqs, w_bits, kv_bits)
        for (w_bits, draft_bits, kv_bits), reqs in sorted(spec.items()):
            self._spec_decode_group(reqs, w_bits, draft_bits, kv_bits)
        self.stats.decode_s += time.perf_counter() - t0
        n_groups = len(plain) + len(spec)
        if n_groups >= 2:
            self.stats.mixed_precision_steps += 1
        return n_groups

    def _plain_decode_group(
        self, reqs: list[ServeRequest], w_bits: int, kv_bits: int
    ) -> None:
        reqs.sort(key=lambda r: r.arrival)
        cache = self.cache_for(kv_bits)
        n_real = len(reqs)
        tokens, lengths, tables, valid = self._batch_arrays(cache, reqs)
        params, pools, cfg = self.params_for(w_bits), cache.pools, self._group_cfg(kv_bits)

        def body(tables, tokens, lengths, valid, samp):
            return paged_decode_sample(params, tokens, lengths, tables, valid != 0, samp,
                                       *pools, cfg=cfg)[0]

        t_call = time.perf_counter()
        sampled = self._group_call("decode", kv_bits, (w_bits,),
                                   [tables, tokens, lengths, valid], reqs, body)
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

    def _spec_decode_group(
        self, reqs: list[ServeRequest], w_bits: int, draft_bits: int, kv_bits: int
    ) -> None:
        """One speculative round for a same-precision group: draft at
        ``draft_bits``, verify at ``w_bits`` under rejection sampling, emit
        the accepted prefix and the resample / bonus token, then return the
        rejected tail pages to the pool."""
        reqs.sort(key=lambda r: r.arrival)
        cache = self.cache_for(kv_bits)
        spec_k = max(r.spec_k for r in reqs)
        capacities = np.array([cache.capacity_tokens(r.rid) for r in reqs], np.int64)
        n_draft = plan_windows(reqs, capacities, spec_k)
        if not n_draft.any():
            # every window shrank to one token (the budget's last token or
            # page pressure): a plain decode call does the same job
            self._plain_decode_group(reqs, w_bits, kv_bits)
            return
        n_real = len(reqs)
        tokens, lengths, tables, valid = self._batch_arrays(cache, reqs)
        nd = np.zeros(len(valid), np.int32)
        nd[:n_real] = n_draft
        draft_params, params = self.params_for(draft_bits), self.params_for(w_bits)
        pools, cfg = cache.pools, self._group_cfg(kv_bits)

        def body(tables, tokens, lengths, valid, nd, samp):
            emit, accept, _ = spec_decode_round(
                draft_params, params, tokens, lengths, tables, valid != 0, nd, samp, *pools,
                cfg=cfg, spec_k=spec_k)
            return torch.cat([emit, accept[:, None].to(emit.dtype)], dim=1)

        t_call = time.perf_counter()
        out = self._group_call("spec", kv_bits, (w_bits, draft_bits, spec_k),
                               [tables, tokens, lengths, valid, nd], reqs, body)
        out = out[:n_real].cpu().numpy()  # the round's one read-back
        emit_np, accept_np = out[:, :-1], out[:, -1]
        self.stats.decode_call_s.append(time.perf_counter() - t_call)
        for i, req in enumerate(reqs):
            n_acc = int(accept_np[i])
            emitted, stopped = clip_stop(req, [int(t) for t in emit_np[i, : n_acc + 1]])
            req.out_tokens.extend(emitted)
            req.cache_len += len(emitted)
            self.stats.tokens_out += len(emitted)
            self.stats.spec_draft_tokens += int(n_draft[i])
            req.spec_drafted += int(n_draft[i])
            # only accepted drafts the emission used: a stop token inside
            # the window discards the accepted tail
            used_acc = min(len(emitted) - 1, n_acc)
            self.stats.spec_accepted_tokens += used_acc
            req.spec_accepted += used_acc
            self._truncate_tail(req)
            if stopped or len(req.out_tokens) >= req.max_new_tokens:
                self._finish(req)
        self.stats.spec_rounds += 1
        self.stats.decode_steps += 1
        self.stats.occupancy_sum += len(reqs)
        key = (w_bits, kv_bits)
        self.stats.group_calls[key] = self.stats.group_calls.get(key, 0) + 1

    def _truncate_tail(self, req: ServeRequest) -> None:
        """Return table pages past ``req.cache_len`` to the pool, forgetting
        any prefix-cache entry of a dropped page first (the verify window may
        have written rejected-token K/V into it)."""
        cache = self.cache_for(req.kv_bits)
        tail = cache.table(req.rid)[cache.pages_for(req.cache_len):]
        if not tail:
            return
        pc = self._prefix.get(req.kv_bits)
        if pc is not None:
            pc.forget_pages(tail)
        cache.truncate(req.rid, req.cache_len)

    def step(self) -> bool:
        """One engine iteration; returns True if any work was done (failing
        an inadmissible request counts: it empties the queue)."""
        failed_before = self.stats.failed
        if self._legacy_prefill:
            worked = bool(self._admit_and_prefill())
        else:
            admitted = self._sched.admit(self._try_admit)
            pumping = any(
                r.state is RequestState.RUNNING and self._prefilling(r)
                for r in self._sched.running
            )
            self._prefill_pump()
            worked = bool(admitted) or pumping
        self._ensure_page_room()
        n_groups = self._decode_groups()
        self.stats.engine_steps += 1
        return worked or n_groups > 0 or self.stats.failed > failed_before

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

"""Synchronous serving facade (port of ``repro/train/server.py``).

Hand a ``Server`` a list of ``Request``s and get them back completed.  The
families the paged engine hosts (dense, vlm, audio, and moe without leading
dense blocks) go to the port's ``ServeEngine``.  Every other family (ssm and hybrid recurrent
caches, and moe with leading dense blocks such as kimi-k2, whose unstacked
prefix the paged engine does not host) is served by the static-wave
scheduler over ``models.transformer``'s
contiguous-cache ``prefill`` / ``decode_step``: waves of ``batch_size``
requests, prompts left-padded with token 0 to a common length, one position
shared by the wave, greedy argmax, each request's first token from the
prefill logits and each decode step feeding the newest token back.

In place of the JAX ``Server``'s jitted ``_decode``, a wave's decode step
and its argmax run as one captured step (``serve/graphs.py``), keyed by
(cfg, w_bits, max_len, the wave's size B, the shape of the tokens it
takes): on the card a CUDA graph captured on first use and
replayed after, eagerly under ``graphs.disable_capture()`` and on the CPU.
Its cache is the Server's own, one per wave size, which every wave's
``prefill`` refills in place, since a captured step reads it by address.
The wave's tokens stay on the device, in a [B, max_new] buffer read back
once at the wave's end.  The one-shot prefill of a wave (the JAX
``Server._prefill``) runs eagerly.

``Server(mesh=)``, a ``("data", "model")`` DeviceMesh with one process per
device, passes the mesh to the paged engine for the families it hosts
(``ServeEngine(mesh=)``, as the JAX ``Server`` does), and serves the static
waves under the tensor-parallel mapping
(``sharding.use_mesh(mesh)``, as the JAX ``Server`` traces its jitted
``prefill`` / ``decode_step`` under ``set_mesh(mesh)``): every rank holds
its blocks of the (quantized) weights under ``tree_shardings``, runs the
same waves on the same requests, computes its rows of each wave (all of
them where the batch ranks do not divide the wave) and its kv heads, and
gathers the logits over ``model`` before the argmax; the wave's tokens are
gathered over the batch ranks at its end.  Under ``moe_dispatch="alltoall"``
(kimi-k2's MoE blocks) each data shard routes its rows of the wave with its
own capacity, as JAX's ``shard_map`` does, and a wave the data axis does
not divide raises ``ValueError``.  Either way every rank returns
the requests completed (rank 0's are the ones to report).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.models import transformer as model_lib
from repro_torch.serve import graphs
from repro_torch.serve.engine import ServeEngine, _to_device
from repro_torch.serve.params import PrecisionParams, SamplingParams


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    out_tokens: list[int] = field(default_factory=list)
    done: bool = False


@dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    decode_steps: int = 0
    tokens_out: int = 0


def engine_family(cfg: ArchConfig) -> bool:
    """The JAX package's ``ServeEngine.supports``: the families its paged
    engine hosts.  Everything else takes the static waves."""
    return cfg.family in ("dense", "vlm", "audio", "moe") and not (
        cfg.family == "moe" and cfg.first_dense
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Server:
    """Blocking facade.  ``batch_size`` bounds the requests served at once
    (engine slots, or the wave size); ``max_len`` sizes the cache of every
    slot.  Runs on the card unless ``device`` names another; with ``mesh``,
    on this rank's blocks under the TP mapping (the module note)."""

    def __init__(
        self,
        arch: ArchConfig,
        params,
        *,
        batch_size: int = 4,
        max_len: int = 512,
        quantize: bool = True,
        page_size: int = 16,
        device=None,
        mesh=None,
    ):
        self.arch = arch
        self.mesh = mesh
        self.batch_size = batch_size
        self.max_len = max_len
        self.w_bits = arch.serve_w_bits if quantize else 16
        self.device = resolve_device(device)
        self.engine = None
        if engine_family(arch):
            pages_per_slot = -(-max_len // page_size)
            self.engine = ServeEngine(
                arch, params, max_slots=batch_size,
                num_pages=batch_size * pages_per_slot, page_size=page_size,
                device=self.device, mesh=mesh,
            )
        else:
            params = _to_device(params, self.device)
            self._params = (model_lib.quantize_params(params, arch.serve_w_bits)
                            if quantize else params)
            if mesh is not None:  # this rank's blocks (at world size 1, the tensors)
                from repro_torch.distributed.elastic import reshard_state

                self._params = reshard_state(self._params, mesh)
            self.graphs = graphs.StepGraphs(self.device)  # the captured wave step
            self._caches: dict[int, dict] = {}  # wave size -> its decode cache
        self.stats = ServeStats()

    @property
    def params(self):
        """Weights actually served (quantized view when enabled)."""
        if self.engine is not None:
            return self.engine.params_for(self.w_bits)
        return self._params

    def serve(self, requests: list[Request], greedy: bool = True) -> list[Request]:
        if not greedy:
            raise NotImplementedError("decoding is greedy-only")
        if self.engine is None:
            return self._serve_waves(requests)
        precision = PrecisionParams(w_bits=self.w_bits)
        handles = [
            self.engine.submit(r.prompt, SamplingParams(max_new_tokens=r.max_new_tokens),
                               precision, rid=r.rid)
            for r in requests
        ]
        self.engine.run()
        for req, h in zip(requests, handles):
            req.out_tokens = list(h.out_tokens)
            req.done = h.done
        es = self.engine.stats
        self.stats = ServeStats(prefill_s=es.prefill_s, decode_s=es.decode_s,
                                decode_steps=es.decode_steps, tokens_out=es.tokens_out)
        return requests

    # ------------------------------------------------- static-wave fallback
    def _make_batch(self, reqs: list[Request]) -> dict:
        s = max(len(r.prompt) for r in reqs)
        toks = np.zeros((len(reqs), s), np.int32)
        for i, r in enumerate(reqs):
            toks[i, s - len(r.prompt):] = r.prompt  # left-pad to align last token
        return {"tokens": torch.from_numpy(toks).to(self.device)}

    @contextlib.contextmanager
    def _mapping(self, b: int):
        """The TP mapping for a wave of ``b`` rows (every row on every rank
        where the batch ranks do not divide ``b``; under the alltoall MoE
        dispatch such a wave raises, as JAX's ``shard_map`` refuses it);
        nothing without a mesh."""
        if self.mesh is None:
            yield
            return
        with sh.use_mesh(self.mesh):
            whole = sh.batch_rows(b) == slice(0, b)
            if whole and sh.batch_ranks() > 1 and self.arch.moe_dispatch == "alltoall":
                raise ValueError(f"a wave of {b} does not divide over the "
                                 f"{sh.batch_ranks()} data shards of moe_dispatch='alltoall'")
            with sh.whole_batch() if whole else contextlib.nullcontext():
                yield

    def prefill_wave(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Prefill a wave (``batch["tokens"] [B, S]``) into the Server's
        cache for B; returns (first tokens [B, 1], that cache).  With a
        mesh: this rank's rows of them (``sharding.batch_rows``)."""
        b = batch["tokens"].shape[0]
        with self._mapping(b):
            batch = {k: v[sh.batch_rows(b)] for k, v in batch.items()} if self.mesh else batch
            if b not in self._caches:
                self._caches[b] = model_lib.init_cache(self.arch, batch["tokens"].shape[0],
                                                       self.max_len, self.device)
            logits, cache = model_lib.prefill(self._params, batch, self.arch, self.max_len,
                                              cache=self._caches[b])
        return logits.argmax(dim=-1, keepdim=True), cache

    def decode_wave(self, tok: torch.Tensor, b: int | None = None) -> torch.Tensor:
        """One decode step of a wave and its argmax, as a captured step:
        tokens [B, 1] -> next tokens [B, 1], the Server's cache for B (the
        last ``prefill_wave``'s) advanced in place.  With a mesh, ``tok``
        holds this rank's rows of a wave of ``b``, which must be given."""
        if b is None:
            if self.mesh is not None:
                raise ValueError("on a mesh, decode_wave takes the wave's size b: "
                                 "tok holds this rank's rows of it")
            b = tok.shape[0]
        cache = self._caches[b]

        def step(tok):
            logits, _ = model_lib.decode_step(self._params, tok, cache, self.arch)
            return logits.argmax(dim=-1, keepdim=True)

        with self._mapping(b):
            return self.graphs.run(self.wave_key(tok, b), step, (tok,))

    def wave_key(self, tok: torch.Tensor, b: int) -> tuple:
        """The captured step's key for ``tok``, this rank's rows of a wave
        of ``b``.  ``b`` is part of it: it picks the step's cache and, on a
        mesh, how the rows split, so two waves whose ranks hold as many
        rows (on a 2-wide data axis a wave of 6, split, and a wave of 3,
        whole on every rank) take different steps."""
        return graphs.step_key("wave_decode", self.arch, (self.w_bits, self.max_len, b),
                               (tok,))

    def _serve_waves(self, requests: list[Request]) -> list[Request]:
        """Waves of batch_size requests with one shared position."""
        pending = list(requests)
        while pending:
            wave = pending[: self.batch_size]
            pending = pending[self.batch_size:]
            t0 = time.perf_counter()
            tok, _ = self.prefill_wave(self._make_batch(wave))
            _sync(self.device)
            self.stats.prefill_s += time.perf_counter() - t0
            max_new = max(r.max_new_tokens for r in wave)
            t0 = time.perf_counter()
            out = torch.empty((tok.shape[0], max_new), dtype=tok.dtype, device=self.device)
            for i in range(max_new):
                out[:, i] = tok[:, 0]
                tok = self.decode_wave(tok, len(wave))
                self.stats.decode_steps += 1
            if self.mesh is not None:  # every batch rank's rows
                with self._mapping(len(wave)):
                    out = sh.batch_all_gather(out)
            picks = out.tolist()  # the wave's one read-back
            self.stats.decode_s += time.perf_counter() - t0
            for i, r in enumerate(wave):
                r.out_tokens.extend(picks[i][: max(r.max_new_tokens - len(r.out_tokens), 0)])
                r.done = True
                self.stats.tokens_out += len(r.out_tokens)
        return requests

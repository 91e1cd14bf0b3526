"""Continuous-batching multi-precision serving engine (port of ``repro.serve``).

Every in-flight request picks its own weight precision (W4A16 / W8A16 /
16-bit) and KV-cache precision (int4 / int8 / 16-bit), and the engine still
batches them: one batched call per precision group per decode step.  Layers,
bottom-up: ``params`` / ``outputs`` (the generation API's types),
``request``, ``kv_cache`` (paged pool with refcounts and copy-on-write),
``prefix_cache`` (block-hash chains, LRU), ``scheduler`` (FCFS admission,
youngest-first preemption), ``prefill`` / ``decode`` (the model steps over
the paged pool) and ``engine`` (``ServeEngine``).  Import the modules
directly; this package file imports nothing.
"""

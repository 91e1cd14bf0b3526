"""Kernels of the serving path: the hand-written CUDA kernels for Hopper
(``csrc/``), their Python wrappers (``mpmm``, ``mqa_decode``,
``paged_decode``, ``paged_prefill``), the plain PyTorch versions (``ref``) and the dispatch
wrappers (``ops``)."""

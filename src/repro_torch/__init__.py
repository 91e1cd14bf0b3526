"""PyTorch/CUDA port of the multi-precision serving stack in ``repro``,
with its training path.

The package mirrors ``repro``'s layout module for module (``configs``,
``quant``, ``core``, ``kernels``, ``models``, ``serve``, ``optim``,
``data``, ``checkpoint``, ``train``, ``distributed``, ``launch``) and
keeps its function names, so each function's counterpart is easy to find.
It imports ``torch`` and numpy only: nothing of JAX and nothing of
``repro``.  The three kernels of the serving path (paged decode, paged
prefill and the W4/W8 dequant matmul) are CUDA C++ for Hopper under
``kernels/csrc``; every kernel keeps a plain PyTorch version beside it,
which the wrappers use for tensors on the CPU.
"""

"""SPEED's core as pure Python, copied from ``repro.core``: precision modes
(``precision``), the custom instructions (``isa``), FF/CF dataflow mapping
(``dataflow``) and the cycle model that picks a dataflow per layer
(``perfmodel``)."""

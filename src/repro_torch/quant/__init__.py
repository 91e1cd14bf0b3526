"""Bit-packing of sub-byte operands (port of ``repro.quant.pack``)."""

"""Precision definitions shared by the port (copy of ``repro.core.precision``)."""

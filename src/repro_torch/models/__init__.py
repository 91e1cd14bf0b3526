"""Model pieces of the serving path (port of the dense subset of ``repro.models``)."""

"""Model pieces of the serving and training paths (port of ``repro.models``)."""

"""Architecture configs the port serves (a copy of ``repro.configs.base``)
and the input-shape registry (a copy of ``repro.configs.shapes``)."""
from repro_torch.configs.base import ArchConfig, get_config, list_archs
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cells_for_arch

__all__ = ["ArchConfig", "get_config", "list_archs", "SHAPES", "ShapeSpec", "cells_for_arch"]

"""Utilities: platform selection, profiling counters, JSONL result records."""

from .platform import use_cpu, use_gpu, ensure_x64, enable_compile_cache
from .vtk import write_vtk, write_vtk_series

__all__ = ["use_cpu", "use_gpu", "ensure_x64", "enable_compile_cache",
           "write_vtk", "write_vtk_series"]

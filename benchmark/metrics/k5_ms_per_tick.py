"""K5's device ms a served tick (the stagewise tick kernel's streamed entry
point), its top-up launches included: ``k4_ms_per_tick``'s reader, taken
from there (the two entry points share the kernel and its names)."""

from benchmark.metrics.k4_ms_per_tick import read  # noqa: F401

"""The work of K5 (``fused_stagewise_tick_streamed``, the streamed entry
point of ``csrc/stagewise_tick.cu``, the same kernel as K4): K4's count,
``roofline/k4.py``'s ``work``, taken from there so that one count serves
both entry points."""

from benchmark.roofline.k4 import work  # noqa: F401

"""The work of K4 (``fused_stagewise_tick``, ``csrc/stagewise_tick.cu``)
for ``n_iter`` stagewise ADMM iterations of ``lanes`` problems of
horizon ``N`` with ``x`` states, ``u`` controls and ``r`` rows a stage.

Operations: per lane, iteration and stage, the backward step (shifted
costs, rows, B'v, the gain product, A'v + K'h) and the forward step (K x,
projections, rows, A x + B u).  Bytes, float32, each once: the problem's
data (dynamics, costs, bounds, rows) and x0 read, the warm state (the
split variables and their duals) read and written, the trajectory and the
controls written.
"""


def work(lanes: int, N: int, x: int, u: int, r: int, n_iter: int):
    """``(name, operations, bytes, precision)`` of the iterations."""
    per_stage = (4 * x * x + 8 * x * u + 2 * u * u + 4 * r * (x + u)
                 + 11 * x + 11 * u + 10 * r)
    flops = float(per_stage) * N * n_iter * lanes
    data = (N * (x * x + x * u + x + u * u + u + 2 * u + r * (x + u) + 2 * r)
            + (N + 1) * (x * x + x + 2 * x) + x)
    state = 2 * ((N + 1) * x + N * u + N * r)
    out = (N + 1) * x + N * u
    nbytes = 4.0 * lanes * (data + 2 * state + out)
    return ("stagewise iterations", flops, nbytes, "float32")

"""The work of the Riccati gains kernel (``riccati_gains_into_plan``,
``csrc/riccati_gains.cu``) for ``lanes`` problems of horizon ``N`` with
``x`` states, ``u`` controls and ``r`` rows a stage: one launch, the
quadratic recursion of every lane written into the tick's plan.

Operations: per lane and stage, ``B'V`` and ``A'V``, ``F = Ru + B'V B``,
``G = S' + B'V A``, ``B'V d`` and ``A'V d``, the Gauss-Jordan inverse of
``F`` on ``[F | I]`` (``u`` pivots over ``u`` rows of ``2 u`` entries),
``K = -F^-1 G``, the next ``V = Qx + A'V A + G'K`` and its symmetric part.
Bytes, float32, each once: the stage data and the ridged Hessians read
(``A``, ``B``, ``d``, ``Qx``, ``Ru``, the rows' cross term ``S``, ``qx``,
``ru``), the plan's data-dependent columns written (``A``, ``B``, ``d``,
``K``, ``nF``, ``qb``, ``rb``).  The rows ``r`` add no work here.
"""


def work(lanes: int, N: int, x: int, u: int, r: int):
    """``(name, operations, bytes, precision)`` of one launch."""
    per_stage = (2 * u * x * x + 2 * x ** 3 + 2 * u * u * x + 2 * u * x * x
                 + 2 * u * x + 2 * x * x + 4 * u ** 3 + 2 * u * u * x
                 + 2 * x ** 3 + 2 * u * x * x + x * x)
    flops = float(per_stage) * N * lanes
    read = (N * (x * x + x * u + x + u * u + x * u + u)
            + (N + 1) * (x * x + x))
    written = N * (x * x + x * u + x + u * x + u * u + u) + (N + 1) * x
    nbytes = 4.0 * lanes * (read + written)
    return ("riccati gains", flops, nbytes, "float32")

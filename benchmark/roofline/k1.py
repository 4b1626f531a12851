"""The work of K1 (``fused_admm_box_lanes``, ``csrc/admm_box.cu``) in one
accurate tick of a fleet of per-lane box QPs: per round, the K-free
iteration from x0 = 0 (``n_iter`` products with the lane's ``Kinv``), and
once a tick the ``n_iter = 0`` pass that forms ``Q s`` (one product with
the lane's ``K``).

Counted from the shapes and the iteration count alone: ``B`` lanes of
``n`` controls, float32.  Each product is ``2 n^2`` operations a lane and
the iteration ~12 more a coordinate; each input is read once (the lane's
``n x n`` matrix and its vectors) and each output written once.
"""


def work(lanes: int, n: int, n_iter: int, rounds: int):
    """``[(name, operations, bytes, precision)]``, one entry a launch."""
    B, f = float(lanes), 4.0
    body = ("x0 = 0 body", n_iter * (2.0 * B * n * n + 12.0 * B * n),
            f * (B * n * n + (5 + 4) * B * n), "float32")
    qx = ("Q x pass", 2.0 * B * n * n, f * (B * n * n + (3 + 4) * B * n),
          "float32")
    return [body] * rounds + [qx]

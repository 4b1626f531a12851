"""Per-step -> full-horizon tiling helpers (port of
``copra_tpu/autospan.py``)."""

from __future__ import annotations

import torch

from ._tensors import as_tensor
from .errors import DimensionError


def span_matrix(mat, new_dim: int, add_cols: int = 0) -> torch.Tensor:
    """Tile ``mat`` block-diagonally until its row count reaches ``new_dim``;
    ``add_cols`` appends that many extra zero column-blocks (the X stack is
    one block longer than U)."""
    mat = as_tensor(mat)
    rows = mat.shape[0]
    if new_dim == rows:
        return mat
    if new_dim % rows != 0:
        raise DimensionError(
            f"cannot span matrix with {rows} rows to {new_dim} rows: "
            f"{new_dim} is not a multiple of {rows}.")
    out = torch.block_diag(*([mat] * (new_dim // rows)))
    if add_cols:
        pad = out.new_zeros((out.shape[0], add_cols * mat.shape[1]))
        out = torch.cat([out, pad], dim=1)
    return out


def span_vector(vec, new_dim: int) -> torch.Tensor:
    """Repeat ``vec`` until its length reaches ``new_dim``."""
    vec = as_tensor(vec)
    rows = vec.shape[0]
    if new_dim == rows:
        return vec
    if new_dim % rows != 0:
        raise DimensionError(
            f"cannot span vector of length {rows} to {new_dim}: "
            f"{new_dim} is not a multiple of {rows}.")
    return vec.repeat(new_dim // rows)

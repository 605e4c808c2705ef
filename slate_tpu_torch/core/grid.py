"""Process grid (port of slate_tpu/core/grid.py), 1 x 1 only.

Every matrix of this slice lives on one device, so the grid is 1 x 1 and
has no mesh.  A larger grid raises until the distributed layer is
ported.
"""

from __future__ import annotations

from ..exceptions import not_ported, slate_error
from ..options import GridOrder


class Grid:
    """A p x q process grid; this slice supports the 1 x 1 grid."""

    def __init__(self, p: int = 1, q: int = 1, *,
                 order: GridOrder = GridOrder.Col):
        slate_error(p >= 1 and q >= 1, "grid dims must be >= 1")
        if p * q > 1:
            raise not_ported(f"a {p}x{q} process grid",
                             "queue 1, item 12 (distributed)")
        self.p = p
        self.q = q
        self.order = order
        self.size = p * q

    def tile_rank(self, i: int, j: int) -> int:
        """Linear rank of tile (i, j)'s owner under this grid's GridOrder
        (ref: grid.py:82)."""
        r, c = i % self.p, j % self.q
        return r + c * self.p if self.order is GridOrder.Col \
            else r * self.q + c

    def __repr__(self):
        return f"Grid(p={self.p}, q={self.q}, order={self.order.value})"

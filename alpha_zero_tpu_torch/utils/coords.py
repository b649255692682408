"""Board coordinate conversions (host-side, I/O only — never on the hot path).

The conversion rules (and hence the method shapes) follow Google's Minigo
``coords.py`` (Apache License 2.0, Copyright 2018 Google LLC), which the
reference vendors as ``alpha_zero/envs/coords.py``; this module keeps the
same conventions so SGF/GTP output is byte-compatible.

Coordinate systems (parity with reference ``alpha_zero/envs/coords.py:15-91``):

- grid coordinate: ``(row, col)`` indexed from the upper-left ``(0, 0)``.
- flat coordinate: ``row * N + col`` in ``[0, N^2)``; ``N^2`` encodes "pass".
- SGF coordinate: two lowercase letters ``(col, row)`` from the upper-left,
  ``'aa'`` is the origin; empty string (and ``'tt'`` for N<=19) is pass.
- GTP coordinate: column letter (skipping ``I``) + row number counted from the
  bottom, e.g. ``'D4'``; ``'pass'`` for a pass move.
"""

from __future__ import annotations

from typing import Optional, Tuple

_SGF_COLUMNS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
_GTP_COLUMNS = "ABCDEFGHJKLMNOPQRSTUVWXYZ"

Coord = Optional[Tuple[int, int]]


class CoordsConvertor:
    """Converts between grid/flat/SGF/GTP coordinates for one board size."""

    def __init__(self, board_size: int) -> None:
        self.board_size = board_size

    # -- flat ---------------------------------------------------------------
    def from_flat(self, flat: int) -> Coord:
        if flat == self.board_size * self.board_size:
            return None
        return divmod(flat, self.board_size)

    def to_flat(self, coord: Coord) -> int:
        if coord is None:
            return self.board_size * self.board_size
        return self.board_size * coord[0] + coord[1]

    # -- sgf ----------------------------------------------------------------
    def from_sgf(self, sgfc: Optional[str]) -> Coord:
        if sgfc is None or sgfc == "" or (self.board_size <= 19 and sgfc == "tt"):
            return None
        return _SGF_COLUMNS.index(sgfc[1]), _SGF_COLUMNS.index(sgfc[0])

    def to_sgf(self, coord: Coord) -> str:
        if coord is None:
            return ""
        return _SGF_COLUMNS[coord[1]] + _SGF_COLUMNS[coord[0]]

    # -- gtp ----------------------------------------------------------------
    def from_gtp(self, gtpc: str) -> Coord:
        gtpc = gtpc.upper()
        if gtpc == "PASS":
            return None
        col = _GTP_COLUMNS.index(gtpc[0])
        row_from_bottom = int(gtpc[1:])
        return self.board_size - row_from_bottom, col

    def to_gtp(self, coord: Coord) -> str:
        if coord is None:
            return "pass"
        row, col = coord
        return "{}{}".format(_GTP_COLUMNS[col], self.board_size - row)

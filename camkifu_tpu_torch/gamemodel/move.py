"""Move — the lingua franca between vision, game model, and GUI.

Copied from camkifu_tpu/gamemodel/move.py. The reference constructs
moves in one of several *coordinate frames* and converts between them; this is
where transpose / off-by-one bugs live, so the conversions are pinned down by
unit tests (tests/test_move.py):

- ``'sgf'``  — two lowercase letters, **column first** then row (SGF standard):
  ``'pd'`` = column 15, row 3 (0-indexed from top-left / SGF origin).
- ``'np'``   — ``(row, col)`` integers, the numpy/openCV frame the vision stack
  uses (row = y = first array axis).
- ``'tk'``   — ``(x_pixel, y_pixel)`` canvas coordinates; x maps to column,
  y maps to row, given a canvas scale (pixels per grid step).

A pass is represented by ``row == col == -1`` (SGF ``[]`` or ``[tt]`` on 19×19).
"""

from __future__ import annotations

from camkifu_tpu_torch.config import guiconf

# Color constants. Integer values match the on-device label convention of the
# stone finders: 0 = empty, 1 = black, 2 = white.
E = "E"
B = "B"
W = "W"

COLOR_TO_INT = {E: 0, B: 1, W: 2}
INT_TO_COLOR = {0: E, 1: B, 2: W}


def opposite(color: str) -> str:
    if color == B:
        return W
    if color == W:
        return B
    raise ValueError(f"no opposite for color {color!r}")


class Move:
    """A colored stone placement (or pass) on a ``gsize``×``gsize`` board."""

    __slots__ = ("color", "row", "col", "number", "gsize")

    def __init__(self, kind: str, value, number: int = -1,
                 gsize: int = guiconf.gsize, canvas_scale: float | None = None):
        """Build a move from one of the three coordinate frames.

        kind='sgf' : value = (color, 'pd')  — SGF letters, column first.
        kind='np'  : value = (color, row, col) — matrix coordinates.
        kind='tk'  : value = (color, x_px, y_px) — canvas pixels; requires
                     canvas_scale (pixels per grid step, intersection 0 at
                     0.5 * canvas_scale).
        """
        self.gsize = gsize
        self.number = number
        if kind == "np":
            color, row, col = value
            self.color = color
            self.row, self.col = int(row), int(col)
        elif kind == "sgf":
            color, letters = value
            self.color = color
            if letters in ("", None) or (gsize <= 19 and letters == "tt"):
                self.row = self.col = -1  # pass
            else:
                # SGF: first letter = column, second = row.
                self.col = ord(letters[0]) - ord("a")
                self.row = ord(letters[1]) - ord("a")
        elif kind == "tk":
            color, x, y = value
            if canvas_scale is None:
                raise ValueError("kind='tk' requires canvas_scale")
            self.color = color
            self.col = int(round(x / canvas_scale - 0.5))
            self.row = int(round(y / canvas_scale - 0.5))
        else:
            raise ValueError(f"unknown coordinate frame {kind!r}")
        if self.color not in (B, W, E):
            raise ValueError(f"bad color {self.color!r}")
        if not self.is_pass:
            if not (0 <= self.row < gsize and 0 <= self.col < gsize):
                raise ValueError(
                    f"move off board: row={self.row} col={self.col} gsize={gsize}")

    # -- frame conversions ---------------------------------------------------

    @property
    def is_pass(self) -> bool:
        return self.row == -1 and self.col == -1

    def get_coord(self, kind: str, canvas_scale: float | None = None):
        if kind == "np":
            return (self.row, self.col)
        if kind == "sgf":
            if self.is_pass:
                return ""
            return chr(ord("a") + self.col) + chr(ord("a") + self.row)
        if kind == "tk":
            if canvas_scale is None:
                raise ValueError("kind='tk' requires canvas_scale")
            return ((self.col + 0.5) * canvas_scale, (self.row + 0.5) * canvas_scale)
        raise ValueError(f"unknown coordinate frame {kind!r}")

    @property
    def sgf(self) -> str:
        return self.get_coord("sgf")

    def copy(self) -> "Move":
        return Move("np", (self.color, self.row, self.col),
                    number=self.number, gsize=self.gsize)

    # -- identity ------------------------------------------------------------

    def __eq__(self, other) -> bool:
        return (isinstance(other, Move) and self.color == other.color
                and self.row == other.row and self.col == other.col)

    def __hash__(self) -> int:
        return hash((self.color, self.row, self.col))

    def __repr__(self) -> str:
        where = "pass" if self.is_pass else f"{self.row},{self.col}"
        return f"Move({self.color} {where})"

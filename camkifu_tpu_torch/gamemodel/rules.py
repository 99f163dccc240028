"""Go rules engine: occupation grid, capture detection, staged put/remove.

Parity: Golib ``golib/model/rules.py`` (SURVEY §2.2) — ``RuleUnsafe`` maintains
a gsize×gsize occupation grid; after a put, neighboring enemy groups with no
liberties are removed **and returned** so the GUI can erase them and the stones
finder reads the post-capture state back (the vision feedback loop of SURVEY
§2.2). Mutations are staged and applied by ``confirm()``; a put that is never
confirmed can be discarded. ``Rule`` wraps it with a re-entrant lock for the
multi-origin (vision + human) callers, standing in for the reference's kifu
RLock discipline.

Copied from camkifu_tpu/gamemodel/rules.py, so that the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import threading

import numpy as np

from camkifu_tpu_torch.config import guiconf
from camkifu_tpu_torch.gamemodel.move import B, E, W, Move, opposite


class IllegalMove(Exception):
    pass


def _neighbors(row: int, col: int, gsize: int):
    if row > 0:
        yield row - 1, col
    if row < gsize - 1:
        yield row + 1, col
    if col > 0:
        yield row, col - 1
    if col < gsize - 1:
        yield row, col + 1


class RuleUnsafe:
    """Not thread-safe — callers synchronize (see ``Rule``)."""

    def __init__(self, gsize: int = guiconf.gsize, allow_suicide: bool = False,
                 enforce_ko: bool = False):
        self.gsize = gsize
        self.allow_suicide = allow_suicide
        #: Simple-ko check (a move may not recreate the position as it stood
        #: before the opponent's last move). Off by default: the vision
        #: pipeline must record whatever is physically on the board, even if
        #: the humans broke the ko rule; turn on for strict editing.
        self.enforce_ko = enforce_ko
        self.stones = np.full((gsize, gsize), E, dtype="<U1")
        self._staged = None  # (grid_after, captured_moves, move) awaiting confirm
        self._history: list[bytes] = []   # last two confirmed positions

    # -- queries ---------------------------------------------------------

    def __getitem__(self, rc) -> str:
        return str(self.stones[rc])

    def copystones(self) -> np.ndarray:
        return self.stones.copy()

    def group_and_liberties(self, row: int, col: int, grid=None):
        """Flood-fill the group at (row, col); return (group set, liberty count)."""
        grid = self.stones if grid is None else grid
        color = grid[row, col]
        if color == E:
            return set(), 0
        group, liberties = set(), set()
        stack = [(row, col)]
        while stack:
            r, c = stack.pop()
            if (r, c) in group:
                continue
            group.add((r, c))
            for nr, nc in _neighbors(r, c, self.gsize):
                v = grid[nr, nc]
                if v == E:
                    liberties.add((nr, nc))
                elif v == color and (nr, nc) not in group:
                    stack.append((nr, nc))
        return group, len(liberties)

    # -- staged mutations --------------------------------------------------

    def put(self, move: Move, reset: bool = True) -> list[Move]:
        """Stage the placement of ``move``; return the list of captured stones.

        Raises IllegalMove on occupied intersection or suicide. Captures are
        computed on the staged grid; ``confirm()`` makes them real.
        """
        if reset:
            self._staged = None
        if move.is_pass:
            self._staged = (self._base_grid().copy(), [], move)
            return []
        grid = self._base_grid().copy()
        r, c = move.row, move.col
        if grid[r, c] != E:
            raise IllegalMove(
                f"{move}: intersection occupied by {grid[r, c]}")
        grid[r, c] = move.color
        captured: list[Move] = []
        enemy = opposite(move.color)
        seen: set[tuple[int, int]] = set()
        for nr, nc in _neighbors(r, c, self.gsize):
            if grid[nr, nc] == enemy and (nr, nc) not in seen:
                group, libs = self.group_and_liberties(nr, nc, grid)
                seen |= group
                if libs == 0:
                    for gr, gc in sorted(group):
                        captured.append(Move("np", (enemy, gr, gc),
                                             gsize=self.gsize))
                        grid[gr, gc] = E
        # Suicide check on the post-capture grid.
        _, own_libs = self.group_and_liberties(r, c, grid)
        if own_libs == 0:
            if not self.allow_suicide:
                raise IllegalMove(f"{move}: suicide")
            group, _ = self.group_and_liberties(r, c, grid)
            for gr, gc in sorted(group):
                captured.append(Move("np", (move.color, gr, gc),
                                     gsize=self.gsize))
                grid[gr, gc] = E
        if self.enforce_ko and len(self._history) >= 2 \
                and grid.tobytes() == self._history[-2]:
            raise IllegalMove(f"{move}: ko (recreates the previous position)")
        self._staged = (grid, captured, move)
        return captured

    def remove(self, move: Move, reset: bool = True) -> None:
        """Stage the removal of the stone at move's position."""
        if reset:
            self._staged = None
        grid = self._base_grid().copy()
        r, c = move.row, move.col
        if grid[r, c] == E:
            raise IllegalMove(f"{move}: nothing to remove")
        if move.color != E and grid[r, c] != move.color:
            raise IllegalMove(
                f"{move}: expected {move.color}, found {grid[r, c]}")
        grid[r, c] = E
        self._staged = (grid, [], move)

    def confirm(self) -> None:
        """Apply the staged mutation to the real grid."""
        if self._staged is None:
            raise IllegalMove("nothing staged to confirm")
        self.stones = self._staged[0]
        self._staged = None
        self._history = (self._history + [self.stones.tobytes()])[-2:]

    def discard(self) -> None:
        self._staged = None

    def _base_grid(self) -> np.ndarray:
        return self._staged[0] if self._staged is not None else self.stones

    # -- convenience ---------------------------------------------------------

    def setup(self, move: Move) -> None:
        """Place (or clear, color=E) a setup stone — SGF AB/AW/AE semantics.

        Setup properties are POSITION EDITS, not moves: no alternation, no
        capture resolution, no suicide check. Routing them through put()
        breaks valid SGFs — a problem file can set up a liberty-less group
        whose surround is listed later in the same node, which put() rejects
        as suicide (or worse, silently "captures" earlier setup stones),
        making the file unloadable.
        """
        self.stones[move.row, move.col] = move.color

    def as_labels(self) -> np.ndarray:
        """Current grid as int8 labels (0=E, 1=B, 2=W) — the device convention."""
        out = np.zeros((self.gsize, self.gsize), dtype=np.int8)
        out[self.stones == B] = 1
        out[self.stones == W] = 2
        return out


class Rule(RuleUnsafe):
    """Thread-safe rules: callers from vision threads and the GUI both mutate
    the game; the reference serializes through the kifu RLock (SURVEY §2.4)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.rlock = threading.RLock()

    def put(self, move, reset=True):
        with self.rlock:
            return super().put(move, reset=reset)

    def remove(self, move, reset=True):
        with self.rlock:
            return super().remove(move, reset=reset)

    def setup(self, move):
        with self.rlock:
            super().setup(move)

    def confirm(self):
        with self.rlock:
            super().confirm()

    def copystones(self):
        with self.rlock:
            return super().copystones()

    def as_labels(self):
        with self.rlock:
            return super().as_labels()

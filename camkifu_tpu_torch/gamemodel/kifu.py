"""Kifu — the game record: a Move-level wrapper over the SGF tree.

Parity: Golib ``golib/model/kifu.py`` (SURVEY §2.2) — append / insert / delete /
relocate moves, save / load ``.sgf``, a "modified" flag used by the controller's
confirm-on-exit, and game info. The kifu IS the deliverable of the whole system
and also its checkpoint format: ``--sgf`` resumes an existing game and detection
continues appending to it (SURVEY §5 checkpoint/resume).

Copied from camkifu_tpu/gamemodel/kifu.py; the SGF it writes is the
reference's, byte for byte (the application tag included).
"""

from __future__ import annotations

import os
import time

from camkifu_tpu_torch.config import guiconf
from camkifu_tpu_torch.gamemodel import sgf
from camkifu_tpu_torch.gamemodel.move import B, W, Move


class Kifu:
    def __init__(self, gsize: int = guiconf.gsize):
        self.gsize = gsize
        self.game = sgf.GameTree()
        root = sgf.Node()
        root.set("FF", "4")
        root.set("GM", "1")
        root.set("SZ", str(gsize))
        root.set("AP", "camkifu_tpu:0.1")
        root.set("DT", time.strftime("%Y-%m-%d"))
        self.game.nodes.append(root)
        self.sgffile: str | None = None
        self.modified = False

    # -- construction ---------------------------------------------------------

    @staticmethod
    def load(path: str):
        with open(path, encoding="utf-8", errors="replace") as f:
            collection = sgf.parse(f.read())
        tree = collection[0]
        root = tree.mainline()[0]
        kifu = Kifu(gsize=int(root.get("SZ", "19")))
        kifu.game = tree
        kifu.sgffile = path
        kifu.modified = False
        return kifu

    @staticmethod
    def new(path: str | None = None, gsize: int = guiconf.gsize) -> "Kifu":
        kifu = Kifu(gsize=gsize)
        kifu.sgffile = path
        return kifu

    # -- move access ------------------------------------------------------------

    def _move_nodes(self) -> list[sgf.Node]:
        return [n for n in self.game.mainline() if "B" in n or "W" in n]

    def setup_stones(self) -> list[Move]:
        """Setup placements from AB/AW properties (handicap stones, problem
        positions) anywhere on the main line, in document order. AE-cleared
        points are dropped."""
        out: list[Move] = []
        for node in self.game.mainline():
            for prop, color in (("AB", B), ("AW", W)):
                for coord in node.properties.get(prop, []):
                    out.append(Move("sgf", (color, coord), gsize=self.gsize))
            for coord in node.properties.get("AE", []):
                cleared = Move("sgf", (B, coord), gsize=self.gsize)
                out = [m for m in out
                       if (m.row, m.col) != (cleared.row, cleared.col)]
        return out

    def moves(self) -> list[Move]:
        """Main-line moves in order, numbered from 1."""
        out = []
        for i, node in enumerate(self._move_nodes()):
            color = B if "B" in node else W
            out.append(Move("sgf", (color, node.get(color)),
                            number=i + 1, gsize=self.gsize))
        return out

    def __len__(self) -> int:
        return len(self._move_nodes())

    def next_color(self) -> str:
        moves = self.moves()
        if not moves:
            return B
        return W if moves[-1].color == B else B

    def lastmove(self) -> Move | None:
        moves = self.moves()
        return moves[-1] if moves else None

    # -- mutation ------------------------------------------------------------

    def _last_tree(self) -> sgf.GameTree:
        tree = self.game
        while tree.variations:
            tree = tree.variations[0]
        return tree

    def append(self, move: Move) -> Move:
        node = sgf.Node()
        node.set(move.color, move.get_coord("sgf"))
        self._last_tree().nodes.append(node)
        self.modified = True
        move.number = len(self._move_nodes())
        return move

    def insert(self, move: Move, number: int) -> Move:
        """Insert a move so that it becomes move ``number`` (1-based) of the
        main line; later moves shift."""
        node = sgf.Node()
        node.set(move.color, move.get_coord("sgf"))
        count = 0
        tree = self.game
        while True:
            for i, existing in enumerate(tree.nodes):
                if "B" in existing or "W" in existing:
                    count += 1
                    if count == number:
                        tree.nodes.insert(i, node)
                        self.modified = True
                        move.number = number
                        return move
            if not tree.variations:
                break
            tree = tree.variations[0]
        return self.append(move)

    def mark(self, move: Move, symbol: str = "TR") -> None:
        """Mark a move's intersection on its node (SGF markup: TR triangle,
        SQ square, MA cross, CR circle)."""
        tree, idx = self._find(move.color, move.get_coord("sgf"))
        if tree is None:
            raise KeyError(f"move not found in kifu: {move}")
        tree.nodes[idx].add(symbol, move.get_coord("sgf"))
        self.modified = True

    def delete(self, move: Move) -> None:
        """Remove the given move (matched by color+position) from the main line.

        The reference deletes the *last* occurrence when a stone is removed by
        a human correction; later moves keep their order (renumbered).
        """
        target = move.get_coord("sgf")
        tree, idx = self._find(move.color, target)
        if tree is None:
            raise KeyError(f"move not found in kifu: {move}")
        del tree.nodes[idx]
        self.modified = True

    def relocate(self, err: Move, exp: Move) -> None:
        """Move a wrongly-located stone: vision said ``err``, human says ``exp``."""
        tree, idx = self._find(err.color, err.get_coord("sgf"))
        if tree is None:
            raise KeyError(f"move not found in kifu: {err}")
        tree.nodes[idx].set(exp.color, exp.get_coord("sgf"))
        self.modified = True

    def _find(self, color: str, sgfcoord: str):
        """Last main-line node bearing (color, coord); returns (tree, index)."""
        found = (None, -1)
        tree = self.game
        while True:
            for i, node in enumerate(tree.nodes):
                if color in node and node.get(color) == sgfcoord:
                    found = (tree, i)
            if not tree.variations:
                return found
            tree = tree.variations[0]

    # -- game info -------------------------------------------------------------

    @property
    def root(self) -> sgf.Node:
        return self.game.nodes[0]

    def set_info(self, ident: str, value: str) -> None:
        self.root.set(ident, value)
        self.modified = True

    def get_info(self, ident: str, default=None):
        return self.root.get(ident, default)

    # -- persistence ----------------------------------------------------------

    def save(self, path: str | None = None) -> str:
        path = path or self.sgffile
        if path is None:
            raise ValueError("no sgf file associated with this kifu")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(sgf.serialize_tree(self.game) + "\n")
        os.replace(tmp, path)
        self.sgffile = path
        self.modified = False
        return path

    def __repr__(self) -> str:
        return f"Kifu({len(self)} moves, file={self.sgffile!r})"

"""SGF (Smart Game Format) tree parser / serializer.

Copied from camkifu_tpu/gamemodel/sgf.py, so that the port imports nothing
of the JAX package.

Parity: the reference vendors a generic SGF parser used by Golib's Kifu
(SURVEY §2.2 — ``golib/model/kifu.py`` + bundled ``sgf`` module). This is an
original implementation of the FF[4] subset the application needs: game trees
with variations, multi-valued properties, escaped ``]`` / ``\\`` in values,
round-trip stable serialization.

Grammar (FF[4]):
    Collection = GameTree+
    GameTree   = '(' Sequence GameTree* ')'
    Sequence   = Node+
    Node       = ';' Property*
    Property   = PropIdent PropValue+
    PropIdent  = UcLetter+
    PropValue  = '[' CValueType ']'
"""

from __future__ import annotations


class Node:
    """One SGF node: an ordered mapping property-ident → list of raw values."""

    def __init__(self):
        self.properties: dict[str, list[str]] = {}

    def get(self, ident: str, default=None):
        vals = self.properties.get(ident)
        return vals[0] if vals else default

    def set(self, ident: str, *values: str) -> None:
        self.properties[ident] = list(values)

    def add(self, ident: str, value: str) -> None:
        self.properties.setdefault(ident, []).append(value)

    def __contains__(self, ident: str) -> bool:
        return ident in self.properties

    def __repr__(self) -> str:
        return ";" + "".join(
            f"{k}{''.join(f'[{v}]' for v in vs)}"
            for k, vs in self.properties.items())


class GameTree:
    """A sequence of nodes followed by zero or more variation subtrees."""

    def __init__(self):
        self.nodes: list[Node] = []
        self.variations: list[GameTree] = []

    def mainline(self) -> list[Node]:
        """Nodes along the main line (first variation at each branch)."""
        out = list(self.nodes)
        tree = self
        while tree.variations:
            tree = tree.variations[0]
            out.extend(tree.nodes)
        return out

    def __repr__(self) -> str:
        return f"GameTree({len(self.nodes)} nodes, {len(self.variations)} vars)"


class Collection:
    def __init__(self):
        self.games: list[GameTree] = []

    def __getitem__(self, i: int) -> GameTree:
        return self.games[i]

    def __len__(self) -> int:
        return len(self.games)


class SgfError(Exception):
    pass


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------

def parse(text: str) -> Collection:
    parser = _Parser(text.lstrip("﻿"))   # tolerate a UTF-8 BOM
    collection = Collection()
    parser.skip_ws()
    while not parser.eof() and parser.peek() == "(":
        collection.games.append(parser.game_tree())
        parser.skip_ws()
    if not collection.games:
        raise SgfError("no game tree found")
    return collection


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.text)

    def peek(self) -> str:
        return self.text[self.pos]

    def skip_ws(self) -> None:
        while not self.eof() and self.text[self.pos].isspace():
            self.pos += 1

    def expect(self, ch: str) -> None:
        if self.eof() or self.text[self.pos] != ch:
            found = "<eof>" if self.eof() else self.text[self.pos]
            raise SgfError(f"expected {ch!r} at {self.pos}, found {found!r}")
        self.pos += 1

    def game_tree(self) -> GameTree:
        self.expect("(")
        tree = GameTree()
        self.skip_ws()
        while not self.eof() and self.peek() == ";":
            tree.nodes.append(self.node())
            self.skip_ws()
        if not tree.nodes:
            raise SgfError(f"empty game tree at {self.pos}")
        while not self.eof() and self.peek() == "(":
            tree.variations.append(self.game_tree())
            self.skip_ws()
        self.expect(")")
        return tree

    def node(self) -> Node:
        self.expect(";")
        node = Node()
        self.skip_ws()
        while not self.eof() and self.peek().isalpha():
            ident = self.ident()
            self.skip_ws()
            if self.eof() or self.peek() != "[":
                raise SgfError(f"property {ident} without value at {self.pos}")
            while not self.eof() and self.peek() == "[":
                node.add(ident, self.value())
                self.skip_ws()
        return node

    def ident(self) -> str:
        start = self.pos
        while not self.eof() and self.text[self.pos].isalpha():
            self.pos += 1
        # FF[4] idents are uppercase; tolerate and normalize lowercase (FF[3]).
        return "".join(c for c in self.text[start:self.pos] if c.isupper()) \
            or self.text[start:self.pos].upper()

    def value(self) -> str:
        self.expect("[")
        out = []
        while True:
            if self.eof():
                raise SgfError("unterminated property value")
            ch = self.text[self.pos]
            if ch == "\\":
                self.pos += 1
                if self.eof():
                    raise SgfError("dangling escape")
                out.append(self.text[self.pos])
                self.pos += 1
            elif ch == "]":
                self.pos += 1
                return "".join(out)
            else:
                out.append(ch)
                self.pos += 1


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------

def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace("]", "\\]")


def serialize_tree(tree: GameTree) -> str:
    parts = ["("]
    for node in tree.nodes:
        parts.append(";")
        for ident, values in node.properties.items():
            parts.append(ident)
            for v in values:
                parts.append(f"[{_escape(v)}]")
        parts.append("\n")
    for var in tree.variations:
        parts.append(serialize_tree(var))
    parts.append(")")
    return "".join(parts)


def serialize(collection: Collection) -> str:
    return "\n".join(serialize_tree(g) for g in collection.games) + "\n"

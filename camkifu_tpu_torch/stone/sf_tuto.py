"""SfTuto — the documented plugin-API tutorial skeleton.

Parity: ``camkifu/stone/sf_tuto.py`` + ``doc/Tutorial.md`` (SURVEY §2.1) —
the minimal example proving finders are pluggable: register the class in
``cvconf.sfinders`` and it appears in the GUI. It "detects" a canned opening
one move per batch, and shows how to draw debug metadata.

See doc/Tutorial.md for the walk-through of writing a real finder.

Copied from camkifu_tpu/stone/sf_tuto.py.
"""

from __future__ import annotations

import numpy as np

from camkifu_tpu_torch.gamemodel.move import B, W
from camkifu_tpu_torch.stone.stonesfinder import StonesFinder

CANNED = [(B, 3, 3), (W, 15, 15), (B, 15, 3), (W, 3, 15), (B, 9, 9)]


class SfTuto(StonesFinder):
    label = "tutorial"

    def __init__(self, vmanager):
        super().__init__(vmanager)
        self._next = 0

    def _doframe(self, frames, n: int | None = None) -> None:
        # A real finder implements _find() and lets the base class diff
        # readings into moves; this skeleton pipes a canned move per batch to
        # demonstrate the suggest channel end-to-end.
        self.metadata["tuto"] = f"canned move {self._next}/{len(CANNED)}"
        if self._next < len(CANNED) and self.controller is not None:
            color, r, c = CANNED[self._next]
            self.suggest(color, r, c)
            self._next += 1

    def _find(self, frames, corners):
        b = frames.shape[0]
        g = self.gsize
        return (np.zeros((b, g, g), np.int8), np.ones((b, g, g), np.float32))

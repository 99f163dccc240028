"""Goban canvas: board display + human-correction input surface.

Parity: ``golib/gui/goban.py`` (SURVEY §2.2) — draws grid, hoshi, stones,
last-move highlight; maps pixels↔intersections (the Move 'tk' frame); click
to put a stone, right-click to delete — the surface through which humans
correct the vision system.

Copied from camkifu_tpu/gui/goban.py, on the port's ``config.guiconf`` and
``gamemodel.move``.
"""

from __future__ import annotations

import tkinter as tk

from camkifu_tpu_torch.config import guiconf
from camkifu_tpu_torch.gamemodel.move import B, W, Move


def resolve_press_release(stones, press_rc, release_rc, gsize: int):
    """Decide what a press→release gesture means (pure logic, testable
    headless — the canvas only feeds it coordinates).

    Returns one of:
      ("put", row, col)            press+release on the same empty point
      ("relocate", err_rc, exp_rc, color)  drag a stone to an empty point
      (None,)                      no-op (drag onto occupied, off-board, …)
    """
    pr, pc = press_rc
    rr, rc_ = release_rc
    inside = 0 <= rr < gsize and 0 <= rc_ < gsize \
        and 0 <= pr < gsize and 0 <= pc < gsize
    if not inside:
        return (None,)
    src = int(stones[pr, pc])
    dst = int(stones[rr, rc_])
    if (pr, pc) == (rr, rc_):
        return ("put", pr, pc) if src == 0 else (None,)
    if src != 0 and dst == 0:
        return ("relocate", (pr, pc), (rr, rc_), "B" if src == 1 else "W")
    return (None,)


class Goban(tk.Canvas):
    def __init__(self, master, controller, size: int = guiconf.canvas_size):
        super().__init__(master, width=size, height=size,
                         background=guiconf.background, highlightthickness=0)
        self.controller = controller
        self.gsize = controller.kifu.gsize
        self.size = size
        self.scale = size / self.gsize        # px per grid step
        self.select_color = B                  # next color for manual put
        self.bind("<ButtonPress-1>", self._on_press)
        self.bind("<B1-Motion>", self._on_motion)
        self.bind("<ButtonRelease-1>", self._on_release)
        self.bind("<Button-3>", self._on_right)
        self._press_rc: tuple[int, int] | None = None
        self._ghost = None                     # drag-feedback oval id
        controller.listeners.append(lambda *a: self.redraw())
        self.redraw()

    # -- drawing -------------------------------------------------------------

    def redraw(self) -> None:
        self.delete("all")
        g, s = self.gsize, self.scale
        lo = 0.5 * s
        hi = (g - 0.5) * s
        for i in range(g):
            p = (i + 0.5) * s
            self.create_line(lo, p, hi, p, fill="#333")
            self.create_line(p, lo, p, hi, fill="#333")
        if g == 19:
            for r in (3, 9, 15):
                for c in (3, 9, 15):
                    x, y = (c + 0.5) * s, (r + 0.5) * s
                    self.create_oval(x - 3, y - 3, x + 3, y + 3, fill="#333")
        stones = self.controller.stones()
        radius = guiconf.stone_ratio * s
        for r in range(g):
            for c in range(g):
                v = stones[r, c]
                if v == 0:
                    continue
                x, y = (c + 0.5) * s, (r + 0.5) * s
                fill = "#111" if v == 1 else "#f4f4f4"
                self.create_oval(x - radius, y - radius, x + radius,
                                 y + radius, fill=fill, outline="#000")
        last = self.controller.kifu.lastmove()
        if last is not None and not last.is_pass \
                and self.controller.nav.at_end():
            x, y = last.get_coord("tk", canvas_scale=s)
            self.create_oval(x - 4, y - 4, x + 4, y + 4, outline="#d22",
                             width=2)

    # -- input ------------------------------------------------------------

    def _rc(self, event) -> tuple[int, int]:
        m = Move("tk", (B, event.x, event.y), canvas_scale=self.scale,
                 gsize=self.gsize)
        return m.row, m.col

    def _on_press(self, event) -> None:
        self._press_rc = self._rc(event)

    def _on_motion(self, event) -> None:
        """Drag feedback: a ghost stone follows the cursor when dragging
        from an occupied intersection (stone relocation, SURVEY §0.5)."""
        if self._press_rc is None:
            return
        r, c = self._press_rc
        stones = self.controller.stones()
        if stones[r, c] == 0:
            return
        radius = guiconf.stone_ratio * self.scale
        if self._ghost is None:
            fill = "#111" if stones[r, c] == 1 else "#f4f4f4"
            self._ghost = self.create_oval(0, 0, 0, 0, fill=fill,
                                           outline="#d22", width=2)
        self.coords(self._ghost, event.x - radius, event.y - radius,
                    event.x + radius, event.y + radius)

    def _on_release(self, event) -> None:
        press, self._press_rc = self._press_rc, None
        if self._ghost is not None:
            self.delete(self._ghost)
            self._ghost = None
        if press is None:
            return
        action = resolve_press_release(self.controller.stones(), press,
                                       self._rc(event), self.gsize)
        if action[0] == "put":
            move = Move("np", (self.select_color, action[1], action[2]),
                        gsize=self.gsize)
            try:
                self.controller.append(move)
            except Exception:
                return
            # A manual put is a correction the finder must learn about.
            if hasattr(self.controller, "corrected"):
                self.controller.corrected(None, move)
            self.select_color = W if move.color == B else B
        elif action[0] == "relocate":
            _, (pr, pc), (rr, rc_), color = action
            err = Move("np", (color, pr, pc), gsize=self.gsize)
            exp = Move("np", (color, rr, rc_), gsize=self.gsize)
            self.controller.relocate(err, exp)
            if hasattr(self.controller, "corrected"):
                self.controller.corrected(err, exp)
        self.redraw()

    def _on_right(self, event) -> None:
        stones = self.controller.stones()
        move = Move("tk", (B, event.x, event.y), canvas_scale=self.scale,
                    gsize=self.gsize)
        v = stones[move.row, move.col]
        if v == 0:
            return
        target = Move("np", ("B" if v == 1 else "W", move.row, move.col),
                      gsize=self.gsize)
        try:
            self.controller.delete(target)
        except KeyError:
            return
        if hasattr(self.controller, "corrected"):
            self.controller.corrected(target, None)
        self.redraw()

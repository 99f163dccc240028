"""Controller stack: game-model mediation + the vision→model command channel.

Parity:
- ``golib/gui/controller.py`` (SURVEY §2.2): ``Controller`` mediates UI↔model,
  holds kifu + rules + a NavState cursor for browsing, and exposes a
  command/api registry.
- ``camkifu/core/controllerv.py`` (SURVEY §2.1): ``ControllerV`` adds the
  thread-safe ``pipe()`` command queue (the only legal channel for
  vision→model mutation), ``cvappend`` (vision moves go through the rules),
  ``corrected()`` human-fix forwarding to the stones finder, and
  autosave-on-exit. ``ControllerVSeq`` executes pipes synchronously for the
  headless/batch harness (SURVEY §4: don't mock threads, bypass them).

Copied from camkifu_tpu/core/controllerv.py (host code, no device).
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from camkifu_tpu_torch.config import guiconf
from camkifu_tpu_torch.gamemodel.kifu import Kifu
from camkifu_tpu_torch.gamemodel.move import B, E, W, Move
from camkifu_tpu_torch.gamemodel.rules import IllegalMove, Rule


class NavState:
    """Cursor over the kifu main line for browsing; the board at position n
    is rebuilt by replaying moves through a scratch rules instance."""

    def __init__(self, controller: "Controller"):
        self.controller = controller
        self.position = 0            # number of moves applied

    def at_end(self) -> bool:
        return self.position >= len(self.controller.kifu)

    def goto(self, position: int) -> None:
        moves = self.controller.kifu.moves()
        position = max(0, min(len(moves), position))
        rules = Rule(gsize=self.controller.kifu.gsize)
        # Setup stones (handicap/problem AB/AW) precede move 1 and are
        # always on. They are position edits: rules.setup bypasses
        # capture/suicide resolution (a valid problem SGF can set up a
        # liberty-less group whose surround appears later in the node —
        # put() would raise and make the file unloadable).
        for stone in self.controller.kifu.setup_stones():
            if rules[stone.row, stone.col] == E:
                rules.setup(stone)
        for move in moves[:position]:
            if not move.is_pass:
                rules.put(move)
                rules.confirm()
        self.position = position
        self.controller.rules = rules
        self.controller._on_nav()

    def forward(self) -> None:
        self.goto(self.position + 1)

    def backward(self) -> None:
        self.goto(self.position - 1)

    def beginning(self) -> None:
        self.goto(0)

    def end(self) -> None:
        self.goto(len(self.controller.kifu))


class Controller:
    """Single-threaded command hub between the game model and its users."""

    def __init__(self, sgffile: str | None = None,
                 gsize: int = guiconf.gsize):
        if sgffile is not None:
            try:
                self.kifu = Kifu.load(sgffile)
            except FileNotFoundError:
                self.kifu = Kifu.new(sgffile, gsize=gsize)
        else:
            self.kifu = Kifu.new(gsize=gsize)
        self.rules = Rule(gsize=self.kifu.gsize)
        self.nav = NavState(self)
        self.api: dict[str, callable] = {
            "append": self.append,
            "delete": self.delete,
            "forward": lambda: self.nav.forward(),
            "backward": lambda: self.nav.backward(),
            "beginning": lambda: self.nav.beginning(),
            "end": lambda: self.nav.end(),
            "save": self.save,
        }
        self.listeners: list = []    # GUI observers: fn(event, *args)
        self.nav.end()

    # -- model mutation (user-originated) ---------------------------------

    def append(self, move: Move) -> list[Move]:
        """Append a move at the end of the game (applies rules + captures)."""
        if not self.nav.at_end():
            self.nav.end()
        captured = self.rules.put(move)
        self.rules.confirm()
        self.kifu.append(move)
        self.nav.position += 1
        self._notify("append", move, captured)
        return captured

    def delete(self, move: Move | None = None) -> None:
        """Delete the given move (or the last one)."""
        target = move or self.kifu.lastmove()
        if target is None:
            return
        self.kifu.delete(target)
        self.nav.goto(min(self.nav.position, len(self.kifu)))
        self._notify("delete", target)

    def relocate(self, err: Move, exp: Move) -> None:
        self.kifu.relocate(err, exp)
        self.nav.goto(self.nav.position)
        self._notify("relocate", err, exp)

    def save(self, path: str | None = None) -> None:
        self.kifu.save(path)
        self._notify("save", self.kifu.sgffile)

    # -- queries -----------------------------------------------------------

    def stones(self) -> np.ndarray:
        """Current board as int8 labels (0=E,1=B,2=W) under the rules lock —
        the snapshot the stones finder diffs against (SURVEY §3.3)."""
        return self.rules.as_labels()

    def next_color(self) -> str:
        return self.kifu.next_color()

    def _notify(self, event: str, *args) -> None:
        for listener in self.listeners:
            listener(event, *args)

    def _on_nav(self) -> None:
        """Hook: called after every navigation move (ControllerV flushes
        deferred vision moves when the cursor returns to the end)."""


class ControllerV(Controller):
    """Vision-aware controller: thread-safe piping + finder feedback."""

    def __init__(self, sgffile: str | None = None,
                 video=None, bounds=(0.0, 1.0),
                 gsize: int = guiconf.gsize):
        self._deferred: list[Move] = []   # before super(): nav.end() fires _on_nav
        self._deferred_bulk: list[list] = []
        super().__init__(sgffile=sgffile, gsize=gsize)
        self.video = video
        self.bounds = bounds
        self.queue: queue.Queue = queue.Queue(maxsize=256)
        self.stones_finder = None     # set by VManager
        self.board_finder = None
        self.api.update({
            "append": self.cvappend,     # piped appends are vision-originated
            "bulk": self.bulk_update,
        })
        self._closed = threading.Event()

    # -- the vision→model channel ------------------------------------------

    def pipe(self, instruction: str, *args) -> None:
        """Enqueue a command for execution on the model-owning thread.

        The reference drains this on the Tk main loop; headless hosts call
        ``process_pipe()``.
        """
        if self._closed.is_set():
            return
        try:
            self.queue.put((instruction, args), timeout=1.0)
        except queue.Full:
            # GUI thread stalled: dropping beats deadlocking the vision
            # worker; persistent readings re-suggest dropped moves.
            self._notify("error", f"command queue full, dropped {instruction}")

    def process_pipe(self, block: bool = False, timeout: float = 0.1) -> int:
        """Drain and execute queued commands; returns number executed."""
        n = 0
        while True:
            try:
                instruction, args = self.queue.get(block=block and n == 0,
                                                   timeout=timeout)
            except queue.Empty:
                return n
            self._execute(instruction, args)
            n += 1

    def _execute(self, instruction: str, args) -> None:
        fn = self.api.get(instruction)
        if fn is None:
            self._notify("error", f"unknown command: {instruction}")
            return
        try:
            fn(*args)
        except IllegalMove as exc:
            self._notify("error", str(exc))
        except Exception as exc:   # a bad command must not kill the executor
            self._notify("error", f"{instruction}: {type(exc).__name__}: {exc}")

    # -- vision-originated mutations ---------------------------------------

    def cvappend(self, move: Move) -> list[Move]:
        """A vision-detected move: through the rules like any other — except
        while the user is browsing history, when vision must not yank the
        cursor. Deferred moves queue up and flush (rules-checked, in order)
        the moment the cursor returns to the end of the game."""
        if not self.nav.at_end():
            self._deferred.append(move)
            self._notify("vision_deferred", move)
            return []
        return self.append(move)

    def _on_nav(self) -> None:
        if self.nav.at_end():
            if self._deferred:
                pending, self._deferred = self._deferred, []
                for move in pending:
                    try:
                        self.append(move)
                    except IllegalMove as exc:
                        self._notify("error", str(exc))
            if self._deferred_bulk:
                pending, self._deferred_bulk = self._deferred_bulk, []
                for updates in pending:
                    self.bulk_update(updates)

    def bulk_update(self, updates) -> None:
        """Apply a list of (err, exp) corrections from a full-board re-scan
        (SURVEY §3.3: periodic re-scan → bulk corrections).

        Deferred while the user browses history, exactly like cvappend:
        append/delete/relocate all jump the nav cursor to the end, and a
        vision-originated event must never yank the cursor mid-browse.
        """
        if not self.nav.at_end():
            self._deferred_bulk.append(list(updates))
            self._notify("vision_deferred", None)
            return
        for err, exp in updates:
            # Per-item isolation (same as the deferred-move flush): by the
            # time a deferred correction applies, the user may have edited
            # the same stone — one stale item must not abort the rest, and
            # a raise mid-flush would escape into the navigation call.
            try:
                if err is None and exp is not None:
                    self.append(exp)
                elif err is not None and exp is None:
                    self.delete(err)
                elif err is not None and exp is not None:
                    self.relocate(err, exp)
            except (IllegalMove, KeyError, ValueError) as exc:
                self._notify("error", f"bulk correction dropped: {exc}")

    # -- human-correction feedback (GUI → vision; SURVEY §3.4) ---------------

    def corrected(self, err: Move | None, exp: Move | None) -> None:
        if self.stones_finder is not None:
            self.stones_finder.corrected(err, exp)

    # -- lifecycle -----------------------------------------------------------

    def close(self, autosave: bool = True) -> None:
        self._closed.set()
        if autosave and self.kifu.modified and self.kifu.sgffile:
            self.kifu.save()


class ControllerVSeq(ControllerV):
    """Headless/batch variant: pipe() executes synchronously (the reference's
    sequential controller used by filecheck — SURVEY §3.5)."""

    def pipe(self, instruction: str, *args) -> None:
        self._execute(instruction, args)

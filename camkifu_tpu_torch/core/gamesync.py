"""Board-state → move-sequence extraction (the "emit moves, not states" core).

Parity: the reference's StonesFinder compares each stabilized board reading
against the controller's current game state under the kifu lock and calls
``suggest(move)`` for consistent new stones (SURVEY §3.3). Device output here
is fixed-shape per-frame board states + confidences (SURVEY §7 hard-part b);
this host module diffs them into moves through the rules engine, so captures
are handled exactly: when a detected move captures, the rules remove the
captured stones and the *post-capture* state is what the next reading is
compared against — the feedback loop SURVEY §2.2 calls out.

Copied from camkifu_tpu/core/gamesync.py (``MoveExtractor``,
``score_moves`` and their constants), so that the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import numpy as np

from camkifu_tpu_torch.config import guiconf
from camkifu_tpu_torch.gamemodel.move import (B, COLOR_TO_INT, INT_TO_COLOR,
                                              Move, opposite)
from camkifu_tpu_torch.gamemodel.rules import IllegalMove, RuleUnsafe

#: Readings a captured stone may keep appearing before its pending-removal
#: entry expires (≈6 s of stabilized readings at 25 fps — generous for a
#: player lifting captures out). Past this, a point still showing the
#: captured color is treated as a genuine replay (too-fast ko) and handed
#: to the bulk contradiction tracker.
PENDING_CAPTURE_TTL = 160

#: Consecutive readings NOT showing the captured color before a pending-
#: removal entry clears. One transient misread (the removing hand grazing
#: the point on the per-frame path) must not drop the entry — the stale
#: stone would re-read as "new" next frame and become the phantom move the
#: mechanism exists to prevent.
PENDING_CLEAR_READINGS = 3


class MoveExtractor:
    """Turns a stream of stabilized board readings into an ordered move list.

    Policy (mirrors the reference's suggest/bulk behavior):
    - A reading identical to the current state emits nothing (idempotent).
    - Exactly one new stone, with every disappearance explained by the capture
      that move produces → emit that move.
    - Two new stones (one of each color, reader caught up after agitation) →
      emit both, alternation order preferred.
    - Anything inconsistent (unexplained disappearances, same-color double
      moves, illegal moves) → reading rejected, nothing emitted. The vote
      layer upstream makes such readings rare; rejection is the reference's
      abstention semantics.
    """

    #: Readings an out-of-turn stone is held before being emitted anyway.
    #: Covers the case where two moves were played during an occlusion (or
    #: commit at different vote latencies) and the *second* stone stabilizes
    #: first: emitting it immediately would record the moves in the wrong
    #: order. Genuine non-alternation (handicap, free placement) still goes
    #: through after the hold expires.
    HOLD_READINGS = 12

    def __init__(self, gsize: int = guiconf.gsize, kifu=None,
                 on_move=None, strict_alternation: bool = False):
        self.rule = RuleUnsafe(gsize=gsize)
        self.kifu = kifu
        self.on_move = on_move          # callback(Move) for controller piping
        self.strict_alternation = strict_alternation
        self.moves: list[Move] = []
        self.rejected = 0
        self._hold: dict[tuple[int, int], int] = {}
        #: Captured stones awaiting PHYSICAL removal: point → [captured
        #: color int, readings left, consecutive non-matching readings].
        #: Readings keep showing a captured
        #: group for seconds (votes hold through the removing hand's
        #: occlusion) — without this filter those stale stones re-read as
        #: "new" and, for multi-stone captures (where re-placing one stone
        #: is NOT suicide — the vacated neighbors are its liberties), get
        #: emitted as phantom enemy moves. An entry clears the moment the
        #: point stops reading as the captured color, or after
        #: PENDING_CAPTURE_TTL readings: physical removal lag is bounded,
        #: and a point STILL showing that color past the TTL is a genuine
        #: too-fast ko replay (never seen empty) — expiring hands it to the
        #: bulk contradiction tracker for repair, a late real move beating
        #: a phantom one.
        self._pending_capture: dict[tuple[int, int], list[int]] = {}
        self._resume_next: str | None = None   # alternation seed after resume

    # -- queries ---------------------------------------------------------

    def state(self) -> np.ndarray:
        return self.rule.as_labels()

    def next_color(self) -> str:
        if not self.moves:
            return self._resume_next or B
        return opposite(self.moves[-1].color)

    def set_next_color(self, color: str) -> None:
        """Seed the alternation tracker (used when resuming from an SGF:
        the extractor's own move list is empty but the game is mid-flight)."""
        self._resume_next = color

    def stale_capture_mask(self, reading: np.ndarray) -> np.ndarray:
        """Bool (g, g): points whose reading is EXPLAINED by a captured
        stone awaiting physical removal. The contradiction tracker must not
        count these — a player leaving captures on the board for a few
        seconds (> BULK_CORRECT_AFTER frames) is normal play, and a bulk
        "fix" would resurrect the dead group in the kifu."""
        out = np.zeros(reading.shape, bool)
        for (r, c), (color, _left, _miss) in self._pending_capture.items():
            if int(reading[r, c]) == color:
                out[r, c] = True
        return out

    # -- main entry ------------------------------------------------------

    def advance(self, reading: np.ndarray) -> list[Move]:
        """Consume one stabilized (gsize, gsize) int label reading; emit moves."""
        reading = np.asarray(reading)
        # Holds for positions no longer reading as stones are stale.
        self._hold = {k: v for k, v in self._hold.items()
                      if reading[k[0], k[1]] != 0}
        # A pending-removal point reading as something other than the
        # captured color for PENDING_CLEAR_READINGS in a row has physically
        # caught up (removed, or replaced); one still showing it past the
        # TTL is a too-fast ko replay — expire it so the late real move
        # can be emitted / the contradiction tracker can repair.
        nxt = {}
        for k, (color, left, misses) in self._pending_capture.items():
            if int(reading[k[0], k[1]]) == color:
                misses = 0
            else:
                misses += 1
                if misses >= PENDING_CLEAR_READINGS:
                    continue
            if left > 1:
                nxt[k] = [color, left - 1, misses]
        self._pending_capture = nxt
        emitted: list[Move] = []
        # Up to two single-move steps per reading (two-stone catch-up case);
        # any residual discrepancy is left for future (better) readings.
        for _ in range(2):
            move = self._one_step(reading)
            if move is None:
                break
            emitted.append(move)
        return emitted

    def _one_step(self, reading: np.ndarray) -> Move | None:
        state = self.state()
        new_mask = (reading != 0) & (state == 0)
        gone_mask = (reading == 0) & (state != 0)
        changed_mask = (reading != 0) & (state != 0) & (reading != state)
        if changed_mask.any():
            # A stone changing color outright is never a legal game event.
            self.rejected += 1
            return None
        new_positions = [
            p for p in zip(*np.nonzero(new_mask))
            if self._pending_capture.get(
                (int(p[0]), int(p[1])), (None,))[0]
            != int(reading[p])]            # stale captured stones, not moves
        if not new_positions:
            if gone_mask.any():
                # Disappearances without a new stone: not a move (could be a
                # hand shadow); reject quietly.
                self.rejected += 1
            return None

        # Prefer stones whose color matches alternation; out-of-turn stones
        # are *held* for a few readings (see HOLD_READINGS) in case the
        # missing opposite-color stone is merely committing late.
        want = self.next_color()
        prefer = [p for p in new_positions
                  if INT_TO_COLOR[int(reading[p])] == want]
        offturn = [p for p in new_positions if p not in prefer]
        held = []
        for p in offturn:
            key = (int(p[0]), int(p[1]))
            self._hold[key] = self._hold.get(key, 0) + 1
            if self._hold[key] <= self.HOLD_READINGS:
                held.append(p)
        candidates = prefer + [p for p in offturn if p not in held]
        # Holds for positions no longer read as new stones are stale.
        live = {(int(a), int(b)) for a, b in new_positions}
        self._hold = {k: v for k, v in self._hold.items() if k in live}
        if not candidates:
            return None

        for r, c in candidates:
            color = INT_TO_COLOR[int(reading[r, c])]
            if self.strict_alternation and color != self.next_color():
                continue
            move = Move("np", (color, int(r), int(c)), gsize=self.rule.gsize)
            try:
                captured = self.rule.put(move)
            except IllegalMove:
                continue
            # Every vanished stone must be explained by this move's captures.
            cap_set = {(m.row, m.col) for m in captured}
            gone_set = set(zip(*np.nonzero(gone_mask)))
            gone_set = {(int(a), int(b)) for a, b in gone_set}
            unexplained = gone_set - cap_set
            # Captured stones the reading still sees are fine for one frame
            # (physical removal lags); captures not yet visible are tolerated.
            if unexplained:
                self.rule.discard()
                continue
            self.rule.confirm()
            for m in captured:
                self._pending_capture[(m.row, m.col)] = \
                    [COLOR_TO_INT[m.color], PENDING_CAPTURE_TTL, 0]
            move.number = len(self.moves) + 1
            self.moves.append(move)
            if self.kifu is not None:
                self.kifu.append(move)
            if self.on_move is not None:
                self.on_move(move)
            return move
        self.rejected += 1
        return None

    # -- human-correction feedback (ControllerV.corrected path) -------------

    def apply_correction(self, err: Move | None, exp: Move | None) -> None:
        """Mirror a human fix into the extractor's game state.

        err=None: stone added manually; exp=None: stone deleted; both set:
        relocated.

        Atomic: every rules op is STAGED and confirmed once at the end; a
        correction that is illegal against the extractor's (possibly
        divergent) state discards cleanly and is dropped — the
        contradiction tracker re-fires later if the disagreement persists.
        A half-applied relocate (removal confirmed, replacement lost) would
        otherwise desynchronize the extractor from both board and
        controller. Move-list edits target the LAST occurrence only: Move
        equality is (color, position), and a point captured then legally
        replayed by the same color appears twice — editing both would
        silently diverge the numbering from the kifu (which edits the last).
        """
        try:
            if err is not None and exp is None:
                self.rule.remove(err)
                self.rule.confirm()
                for i in range(len(self.moves) - 1, -1, -1):
                    if self.moves[i] == err:
                        del self.moves[i]
                        break
            elif err is None and exp is not None:
                self.rule.put(exp, reset=True)
                self.rule.confirm()
                if exp.number < 0:
                    exp.number = len(self.moves) + 1
                self.moves.append(exp)
            elif err is not None and exp is not None:
                self.rule.remove(err, reset=True)
                self.rule.put(exp, reset=False)
                self.rule.confirm()
                for i in range(len(self.moves) - 1, -1, -1):
                    if self.moves[i] == err:
                        self.moves[i] = exp
                        break
        except IllegalMove:
            self.rule.discard()
            self.rejected += 1


def score_moves(detected: list[Move], reference: list[Move],
                with_ops: bool = False) -> dict:
    """Move-sequence agreement — the filecheck metric (SURVEY §3.5/§6).

    The sequences are *aligned* (minimum-edit-distance, as the reference's
    checker reported good/wrong/missing per alignment) rather than zipped
    positionally: one early missed move then scores as exactly one "missing"
    instead of turning every subsequent correct move into "wrong". Counts:
    good = aligned equal pairs, wrong = aligned substitutions, missing =
    reference moves with no detected counterpart, extra = detected moves with
    no reference counterpart. agreement = good / len(reference).

    with_ops=True adds "ops": the alignment as (kind, detected_index,
    reference_index) triples in sequence order (indices None where the kind
    has no counterpart) — the source for human-readable diffs.
    """
    n, m = len(detected), len(reference)
    # DP over (detected, reference) prefixes: cost 0 for a match, 1 for a
    # substitution / insertion / deletion. Sequences are game-length (tens to
    # a few hundred moves) — O(n·m) host Python is negligible.
    cost = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        cost[i][0] = i
    for j in range(1, m + 1):
        cost[0][j] = j
    for i in range(1, n + 1):
        di = detected[i - 1]
        row, prev = cost[i], cost[i - 1]
        for j in range(1, m + 1):
            sub = prev[j - 1] + (0 if di == reference[j - 1] else 1)
            row[j] = min(sub, prev[j] + 1, row[j - 1] + 1)
    # Backtrack, preferring matches, then substitutions.
    good = wrong = missing = extra = 0
    ops: list[tuple[str, int | None, int | None]] = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and cost[i][j] == cost[i - 1][j - 1] \
                and detected[i - 1] == reference[j - 1]:
            good += 1
            ops.append(("good", i - 1, j - 1))
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and cost[i][j] == cost[i - 1][j - 1] + 1:
            wrong += 1
            ops.append(("wrong", i - 1, j - 1))
            i, j = i - 1, j - 1
        elif j > 0 and cost[i][j] == cost[i][j - 1] + 1:
            missing += 1
            ops.append(("missing", None, j - 1))
            j -= 1
        else:
            extra += 1
            ops.append(("extra", i - 1, None))
            i -= 1
    agreement = good / m if reference else 1.0
    report = {"good": good, "wrong": wrong, "missing": missing,
              "extra": extra, "ref_moves": m,
              "detected_moves": n, "agreement": agreement}
    if with_ops:
        ops.reverse()
        report["ops"] = ops
    return report

"""The game model the port's host code uses: moves, the rules engine, the
kifu and its SGF format, copied from camkifu_tpu/gamemodel."""

from camkifu_tpu_torch.gamemodel.move import B, E, W, Move, opposite
from camkifu_tpu_torch.gamemodel.rules import IllegalMove, Rule, RuleUnsafe
from camkifu_tpu_torch.gamemodel.kifu import Kifu
from camkifu_tpu_torch.gamemodel import sgf

__all__ = ["Move", "B", "W", "E", "opposite",
           "Rule", "RuleUnsafe", "IllegalMove",
           "Kifu", "sgf"]

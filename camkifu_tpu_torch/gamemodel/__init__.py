"""The game model the port's host code uses: moves and the rules engine,
copied from camkifu_tpu/gamemodel (move.py, rules.py)."""

from camkifu_tpu_torch.gamemodel.move import B, E, W, Move, opposite
from camkifu_tpu_torch.gamemodel.rules import IllegalMove, Rule, RuleUnsafe

__all__ = ["Move", "B", "W", "E", "opposite",
           "Rule", "RuleUnsafe", "IllegalMove"]

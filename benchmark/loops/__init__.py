"""How a traffic mix offers its batches, one module a loop, found by the
mix's ``loop`` key: ``run(program, mix, rec, first)``."""

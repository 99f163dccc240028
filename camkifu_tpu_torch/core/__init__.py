"""Host code of the port: board readings to moves (copied from
camkifu_tpu/core/gamesync.py)."""

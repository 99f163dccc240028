"""Board detection (port of camkifu_tpu.board)."""

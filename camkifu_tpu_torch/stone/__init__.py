"""Stone classification (port of camkifu_tpu.stone)."""

"""Several independent video streams at once (port of
camkifu_tpu.parallel)."""

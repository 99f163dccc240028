"""The benchmark of ``camkifu_tpu_torch``: ``python3 benchmark/run.py``."""

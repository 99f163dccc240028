"""Several independent video streams at once (``mesh``) and training over
several processes (``train``): port of camkifu_tpu.parallel."""

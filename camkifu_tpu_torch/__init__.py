"""PyTorch port of camkifu_tpu's device code, for CUDA on NVIDIA Hopper.

The JAX package ``camkifu_tpu`` is the reference; this package imports
nothing of it (the host code it needs is copied into ``config``,
``gamemodel`` and ``core``). It ports the fixed-camera still path (board
detection, ``board.bf_auto.detect_corners``, and stone classification,
``pipeline.read_board_batch``) and the recorded-video path
(``filecheck.run_pipeline``). Every function runs on its input's device:
on a CUDA tensor the warp, edge and Hough work goes through hand-written
kernels (``ops/cuda``, sources in ``csrc``), on a CPU tensor through their
plain PyTorch versions.
"""

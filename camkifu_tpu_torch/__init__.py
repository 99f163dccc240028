"""PyTorch port of camkifu_tpu's device code, for CUDA on NVIDIA Hopper.

The JAX package ``camkifu_tpu`` is the reference. This package ports its
fixed-camera still path: board detection (``board.bf_auto.detect_corners``)
and stone classification (``pipeline.read_board_batch``). Every function
runs on its input's device: on a CUDA tensor the warp, edge and Hough work
goes through hand-written kernels (``ops/cuda``, sources in ``csrc``), on a
CPU tensor through their plain PyTorch versions.
"""

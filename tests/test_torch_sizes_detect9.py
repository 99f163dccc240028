"""Board size 9 in the port's detection against the JAX reference on the
CPU: ``bf_auto._gsize_probe`` at gsize 9 on a true 9×9 board and on a
13×13 one (the impostor ``infer_gsize`` must score low), which holds
``detect_corners`` (``refine_iters=1``) at 9 too. One JAX compile (the
probe at 9, at one frame shape); gsize 13 is in
``test_torch_sizes_detect13.py``, so the two compiles run on two workers.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu.board import bf_auto as jbf
from camkifu_tpu_torch.board import bf_auto
from camkifu_tpu_torch.utils.still import render_still

torch.set_num_threads(1)

HW = (720, 1280)
#: Corners in frame px, the detection score, the probe's quality.
TOL_PX, TOL_SCORE, TOL_Q = 0.5, 1e-4, 1e-3


def sized_board(g: int):
    """tests/test_board_sizes.py's board of two stones at size ``g``, drawn
    by the port's numpy renderer → (frame (H, W, 3) uint8, true corners)."""
    labels = np.zeros((g, g), np.int8)
    labels[2, 2] = 1
    labels[g - 3, g - 3] = 2
    return render_still(labels, frame_hw=HW, seed=g)


@pytest.mark.parametrize("true_g", [9, 13])
def test_gsize_probe_at_9_matches_jax(true_g):
    frame, truth = sized_board(true_g)
    cs_j, sc_j, q_j = jbf._gsize_probe(jnp.asarray(frame), gsize=9)
    cs_t, sc_t, q_t = bf_auto._gsize_probe(torch.from_numpy(frame), gsize=9)
    assert cs_t.shape == (4, 2) and cs_t.dtype == torch.float32
    assert np.abs(cs_t.numpy() - np.asarray(cs_j)).max() < TOL_PX
    assert abs(float(sc_t) - float(sc_j)) < TOL_SCORE
    assert abs(float(q_t) - float(q_j)) < TOL_Q
    if true_g == 9:
        # The probe's corners are detect_corners' at refine_iters=1 (its
        # stages 1–3), and tests/test_board_sizes.py's gate holds them to
        # the truth.
        cell = float(np.linalg.norm(truth[1] - truth[0])) / 8
        assert float(sc_t) > 0.5
        assert np.abs(cs_t.numpy() - truth).max() < 0.2 * cell
        assert float(q_t) > 0.5

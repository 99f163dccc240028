"""The port's detection probe of the k1 calibration
(``bf_auto._detect_k1_probe``: undistort the frame, detect at res 512,
score line-scale lattice evidence, bend the corners back) against the JAX
reference on a 480×854 render through a k1 = 0.06 lens. One JAX compile
(most of the file's time): the reference traces k1, so one probe."""

import numpy as np
import jax.numpy as jnp
import torch

from camkifu_tpu.board import bf_auto as jbf
from camkifu_tpu.utils import synth
from camkifu_tpu_torch.board import bf_auto

torch.set_num_threads(1)

HW = (480, 854)
#: Corners in frame px, score and quality: the port's detector runs the
#: reference's steps in float32, its sums in other orders.
TOL_PX = 0.5
TOL_SCORE = 1e-3


def test_detect_k1_probe_matches_jax():
    rng = np.random.default_rng(13)
    labels = np.zeros((19, 19), np.int8)
    idx = rng.choice(361, 60, replace=False)
    labels.flat[idx[:30]] = 1
    labels.flat[idx[30:]] = 2
    frame, truth = synth.render_frame(
        labels, corners=synth.default_corners(HW, perspective=0.12),
        frame_hw=HW, lens_k1=0.06, seed=5)
    c_j, s_j, q_j = jbf._detect_k1_probe(jnp.asarray(frame),
                                         jnp.float32(0.06))
    c_t, s_t, q_t = bf_auto._detect_k1_probe(torch.from_numpy(frame), 0.06)
    assert c_t.shape == (4, 2) and c_t.dtype == torch.float32
    assert np.abs(c_t.numpy() - np.asarray(c_j)).max() <= TOL_PX
    assert abs(float(s_t) - float(s_j)) <= TOL_SCORE
    assert abs(float(q_t) - float(q_j)) <= TOL_SCORE
    # Raw frame corners near the truth (the reference's 0.15 cell); the
    # pinhole probe on the same frame lands further off, with a lower
    # quality.
    cell = np.linalg.norm(truth[1] - truth[0]) / 18.0
    assert np.abs(c_t.numpy() - truth).max() < 0.15 * cell
    c0, _, q0 = bf_auto._detect_k1_probe(torch.from_numpy(frame), 0.0)
    assert np.abs(c0.numpy() - truth).max() > 0.3 * cell
    assert float(q0) < float(q_t)

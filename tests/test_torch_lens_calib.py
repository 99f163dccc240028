"""The port's k1 calibration from known corners against the JAX reference
on the CPU: the two probes at three k1 values on a 720p render, the sweep
and the bow refinement (host code) on Python objectives, and the
calibrator itself held to the truth at ``tests/test_lens_e2e.py``'s
tolerances. The detection probe is in ``test_torch_lens_detect.py``."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu.board import bf_auto as jbf
from camkifu_tpu.utils import synth
from camkifu_tpu_torch.board import bf_auto

torch.set_num_threads(1)

HW = (720, 1280)
#: ``_corners_k1_probe``'s quality (evidence in [0, 1]) and
#: ``_corners_bow_probe``'s bow (rect px): the same float32 steps in both
#: packages, summed in other orders.
TOL_Q = 1e-4
TOL_BOW = 1e-3


@functools.lru_cache(maxsize=3)
def _board(true_k1: float):
    """tests/test_lens_e2e.py's board (60 stones, seed 13) at 720p through
    a ``true_k1`` lens: (frame, true raw corners)."""
    rng = np.random.default_rng(13)
    labels = np.zeros((19, 19), np.int8)
    idx = rng.choice(361, 60, replace=False)
    labels.flat[idx[:30]] = 1
    labels.flat[idx[30:]] = 2
    corners = synth.default_corners(HW, perspective=0.12)
    return synth.render_frame(labels, corners=corners, frame_hw=HW,
                              lens_k1=true_k1, seed=5)


@pytest.mark.parametrize("k1", [-0.035, 0.0, 0.06])
def test_corner_probes_match_jax(k1):
    """Both probes on the k1 = 0.06 board at a wrong, a pinhole and the
    true k1."""
    frame, truth = _board(0.06)
    zone = bf_auto._cal_zone(19)
    assert zone == 27
    ft, ct = torch.from_numpy(frame), torch.from_numpy(truth)
    fj, cj = jnp.asarray(frame), jnp.asarray(truth)
    q_t = float(bf_auto._corners_k1_probe(ft, ct, k1, zone=zone))
    q_j = float(jbf._corners_k1_probe(fj, cj, jnp.float32(k1), zone=zone))
    assert abs(q_t - q_j) <= TOL_Q, (q_t, q_j)
    b_t = float(bf_auto._corners_bow_probe(ft, ct, k1, zone=zone))
    b_j = float(jbf._corners_bow_probe(fj, cj, jnp.float32(k1), zone=zone))
    assert abs(b_t - b_j) <= TOL_BOW, (b_t, b_j)


def _objectives():
    """Python quality and bow curves: a peak with a plateau, a spike, a
    flat curve (phantom lens), and bows with their minimum off the grid."""
    return [
        lambda k: 1.0 - abs(k - 0.047) * 8.0,
        lambda k: 0.5 + (0.9 if abs(k + 0.06) < 1e-9 else 0.0),
        lambda k: 0.3 + 0.01 * np.sin(40 * k),
        lambda k: float(np.round(1.0 - abs(k - 0.11) * 3.0, 2)),
        lambda k: -1.0 if k > 0.1 else 0.2 - abs(k + 0.012),
    ]


@pytest.mark.parametrize("i", range(5))
def test_sweep_and_bow_refine_equal_the_reference(i):
    """Host code, copied: equal results, and the same probes in the same
    order."""
    q_at = _objectives()[i]
    for grid in (bf_auto.K1_CAL_GRID, (-0.05, 0.0, 0.05)):
        seen_t, seen_j = [], []
        got = bf_auto._k1_sweep(lambda k: seen_t.append(k) or q_at(k), grid)
        want = jbf._k1_sweep(lambda k: seen_j.append(k) or q_at(k), grid)
        assert got == want and seen_t == seen_j
    for k0 in (0.06, -0.035, 0.0):
        def bow_at(k, seen):
            seen.append(k)
            return abs(k - (0.0137 * (i + 1) - 0.03)) + 0.001 * (i % 2)
        seen_t, seen_j = [], []
        assert bf_auto._k1_bow_refine(lambda k: bow_at(k, seen_t), k0) \
            == jbf._k1_bow_refine(lambda k: bow_at(k, seen_j), k0)
        assert seen_t == seen_j
    assert bf_auto.K1_CAL_GRID == jbf.K1_CAL_GRID
    assert bf_auto.K1_CAL_MARGIN == jbf.K1_CAL_MARGIN


@pytest.mark.parametrize("true_k1", [0.08, -0.06])
def test_estimate_corners_recovers_k1(true_k1):
    """tests/test_lens_e2e.py's assertions on the port alone: k1 within
    ±0.004 of the truth from the true corners, with a gain past the
    margin."""
    frame, truth = _board(true_k1)
    est, gain = bf_auto.estimate_lens_k1_corners(torch.from_numpy(frame),
                                                 truth)
    assert abs(est - true_k1) < 0.004, (est, gain)
    assert gain > bf_auto.K1_CAL_MARGIN
    assert isinstance(est, float)


def test_estimate_corners_rejects_phantom_lens():
    """Pinhole footage with known corners calibrates to exactly 0."""
    frame, truth = _board(0.0)
    est, _ = bf_auto.estimate_lens_k1_corners(torch.from_numpy(frame),
                                              torch.from_numpy(truth))
    assert est == 0.0


def test_bow_windows_are_made_once():
    """The bow probe's static centroid windows: one set per (gsize, zone,
    device), the reference's positions."""
    a = bf_auto._bow_windows(19, 27, torch.device("cpu"))
    assert bf_auto._bow_windows(19, 27, torch.device("cpu")) is a
    idx, taps, ctr = a
    centers = 27 / 2.0 - 0.5 + 27 * np.arange(19)
    assert idx.shape == (19, 2 * (27 // 2 - 3) + 1)
    np.testing.assert_array_equal(ctr.numpy(), centers.astype(np.float32))
    np.testing.assert_array_equal(taps.numpy(), idx.numpy())
    assert int(idx.min()) >= 0 and int(idx.max()) < 19 * 27

"""The port's board detection against the JAX reference on the CPU: the
coarse stage on the same edge magnitudes, ``detect_corners`` end to end on
720p synthetic boards, and the numpy-only still the smoke run uses, read
through the JAX package."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu import pipeline as jpipeline
from camkifu_tpu.board import bf_auto as jbf
from camkifu_tpu.ops.color import rgb_to_gray
from camkifu_tpu.ops.edges import edge_map as jedge_map
from camkifu_tpu.utils import synth
from camkifu_tpu_torch.board import bf_auto
from camkifu_tpu_torch.utils.still import render_still

torch.set_num_threads(1)

#: tests/test_bf_auto.py's corner tolerance against ground truth at 720p.
TOL_PX = 11.0
HW = (720, 1280)

#: tests/test_bf_auto.py's boards: (stones, seed, in-plane rotation in
#: degrees, line-dominated). The rotated board takes the refine's
#: de-rotation pass; the saturated one (score ≤ 0.55) its polish branch.
BOARDS = {"lines": (40, 1, 0, True), "rotated": (60, 3, 18, True),
          "saturated": (250, 3, 0, False)}


def board(nstones, seed):
    labels = np.zeros((19, 19), np.int8)
    if nstones:
        idx = np.random.default_rng(seed).choice(361, nstones, replace=False)
        labels.flat[idx[::2]] = 1
        labels.flat[idx[1::2]] = 2
    return labels


def test_coarse_from_mag_matches_jax():
    """Same luma and chroma magnitudes (from the JAX edge stage) into both
    coarse stages: quad within 0.5 px at 256², score within 1e-3."""
    frame, _ = synth.render_frame(board(40, 1), frame_hw=(360, 640), seed=1)
    f = jnp.asarray(frame)
    small = jax.image.resize(rgb_to_gray(f.astype(jnp.float32) / 255.0),
                             (256, 256), method="bilinear")
    chroma = jax.image.resize((f[..., 0].astype(jnp.float32)
                               - f[..., 2].astype(jnp.float32)) / 255.0,
                              (256, 256), method="bilinear")
    mag = np.array(jedge_map(small, backend="xla"))
    mag_c = np.array(jedge_map(chroma, backend="xla"))
    quad_j, score_j = jax.jit(jbf._coarse_from_mag)(jnp.asarray(mag),
                                                    jnp.asarray(mag_c))
    quad_t, score_t = bf_auto._coarse_from_mag(torch.from_numpy(mag),
                                               torch.from_numpy(mag_c))
    assert np.abs(quad_t.numpy() - np.asarray(quad_j)).max() < 0.5
    assert abs(float(score_t) - float(score_j)) < 1e-3
    assert float(score_t) > 0.5


@pytest.mark.parametrize("kind", sorted(BOARDS))
def test_detect_corners_matches_jax(kind):
    nstones, seed, deg, line_dominated = BOARDS[kind]
    corners = synth.default_corners(HW)
    th = np.deg2rad(deg)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    ctr = corners.mean(axis=0)
    corners = (ctr + (corners - ctr) @ rot.T).astype(np.float32)
    frame, corners = synth.render_frame(board(nstones, seed), corners=corners,
                                        frame_hw=HW, seed=seed)
    ref, ref_score = jbf.detect_corners(jnp.asarray(frame))
    ours, score = bf_auto.detect_corners(torch.from_numpy(frame))
    assert ours.dtype == torch.float32 and ours.shape == (4, 2)
    assert (float(score) > 0.55) == line_dominated
    assert abs(float(score) - float(ref_score)) < 1e-3
    assert np.abs(ours.numpy() - np.asarray(ref)).max() < 1.0
    assert np.abs(ours.numpy() - corners).max() < TOL_PX


def test_still_reads_right_through_jax():
    """The smoke run's numpy-only still is held to the reference: the JAX
    package detects its board and reads every stone."""
    labels = board(100, 0)
    frame, corners = render_still(labels, frame_hw=HW)
    assert frame.dtype == np.uint8 and frame.shape == HW + (3,)
    det, score = jbf.detect_corners(jnp.asarray(frame))
    assert float(score) > 0.1
    assert np.abs(np.asarray(det) - corners).max() < TOL_PX
    out, _ = jpipeline.read_board_batch(jnp.asarray(frame[None]), det)
    assert np.array_equal(np.asarray(out[0]), labels)

"""The port's read_board_batch against the JAX pipeline on the CPU: the same
synthetic 360×640 frames and corners through both (the cases of
tests/test_pipeline_slice.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu import pipeline as jpipeline
from camkifu_tpu.utils import synth
from camkifu_tpu_torch import pipeline
from camkifu_tpu_torch.stone import sf_clustering

torch.set_num_threads(1)

HW = (360, 640)


def _labels(case):
    labels = np.zeros((19, 19), np.int8)
    if case == "sparse":
        labels[3, 3] = 1
        labels[15, 15] = 2
    elif case == "120":
        idx = np.random.default_rng(0).choice(361, 120, replace=False)
        labels.flat[idx[:60]] = 1
        labels.flat[idx[60:]] = 2
    return labels


@pytest.mark.parametrize("case", ["empty", "sparse", "120"])
def test_read_board_batch_matches_jax(case):
    labels = _labels(case)
    frame, corners = synth.render_frame(labels, frame_hw=HW)
    ours, conf = pipeline.read_board_batch(torch.from_numpy(frame[None]),
                                           torch.from_numpy(corners))
    ref, ref_conf = jpipeline.read_board_batch(jnp.asarray(frame[None]),
                                               jnp.asarray(corners))
    assert ours.dtype == torch.int8 and ours.shape == (1, 19, 19)
    assert np.array_equal(ours.numpy(), np.asarray(ref))
    assert np.array_equal(ours.numpy()[0], labels)
    np.testing.assert_allclose(conf.numpy(), np.asarray(ref_conf), atol=5e-3)


def test_batch_equals_frames_one_by_one():
    """The batch dimension replaces the reference's vmap: every frame of a
    mixed batch reads as it does alone."""
    frames = []
    for i, case in enumerate(("empty", "sparse", "120")):
        f, corners = synth.render_frame(_labels(case), frame_hw=HW, seed=i)
        frames.append(f)
    batch = torch.from_numpy(np.stack(frames))
    c = torch.from_numpy(corners)
    labels, conf = pipeline.read_board_batch(batch, c)
    for i in range(3):
        one, one_conf = pipeline.read_board_batch(batch[i:i + 1], c)
        assert torch.equal(labels[i], one[0])
        # Batched sums run in another order: float32 rounding only.
        torch.testing.assert_close(conf[i], one_conf[0], atol=1e-5, rtol=0)
    # The classifier alone also takes an unbatched canonical image.
    canon = torch.rand(304, 304, 3, generator=torch.Generator().manual_seed(0))
    l1, _ = sf_clustering.classify_canonical(canon)
    l2, _ = sf_clustering.classify_canonical(canon[None])
    assert torch.equal(l1, l2[0])


def test_per_frame_corners_are_not_ported_yet():
    """Kept under its first name: per-frame corners were refused until the
    tracking slice; now they go through ``warp_batch_chunked``, and a
    steady camera's (1, 4, 2) corners read as its (4, 2) corners do."""
    frame, corners = synth.render_frame(_labels("sparse"), frame_hw=HW)
    per, per_conf = pipeline.read_board_batch(torch.from_numpy(frame[None]),
                                              torch.from_numpy(corners[None]))
    ref, ref_conf = jpipeline.read_board_batch(jnp.asarray(frame[None]),
                                               jnp.asarray(corners[None]))
    fixed, _ = pipeline.read_board_batch(torch.from_numpy(frame[None]),
                                         torch.from_numpy(corners))
    assert np.array_equal(per.numpy(), np.asarray(ref))
    assert torch.equal(per, fixed)
    np.testing.assert_allclose(per_conf.numpy(), np.asarray(ref_conf),
                               atol=5e-3)

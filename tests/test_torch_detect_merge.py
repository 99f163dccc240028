"""The port's ``detect_batch`` end to end against the JAX reference on the
CPU, on a batch in which one chunk fails validation and is refined frame
by frame. Apart from ``test_torch_detect_route.py`` because the JAX side
compiles its whole batched detector and its per-frame refine."""

import numpy as np
import jax.numpy as jnp
import torch

from camkifu_tpu.board import bf_auto as jbf
from camkifu_tpu.utils import synth
from camkifu_tpu_torch.board import bf_auto

torch.set_num_threads(1)

HW = (360, 640)
RES = 256
#: tests/test_bf_auto.py's 11 px at 720p, at 360p.
TOL_PX = 5.5


def _labels(n, seed):
    labels = np.zeros((19, 19), np.int8)
    idx = np.random.default_rng(seed).choice(361, n, replace=False)
    labels.flat[idx[::2]] = 1
    labels.flat[idx[1::2]] = 2
    return labels


def _frames():
    """Three frames of tests/test_detect_shared.py's drifting batch at
    360×640, then a saturated 250-stone board (score ≤ 0.55)."""
    base = synth.default_corners(HW)
    frames, gts = [], []
    for i in range(3):
        c = base + np.array([3.0 * np.sin(i / 2.0), 3.0 * np.cos(i / 3.0)],
                            np.float32)
        f, gt = synth.render_frame(_labels(40, 1), c, HW, seed=i)
        frames.append(f)
        gts.append(gt)
    sat, _ = synth.render_frame(_labels(250, 3), None, HW, seed=3)
    return np.stack(frames + [sat]), np.stack(gts)


def test_detect_batch_merges_a_failed_chunk(monkeypatch):
    """Chunks of 2: the drifting chunk keeps its shared-canvas corners, the
    chunk holding a saturated board is refined frame by frame, exactly as
    ``_detect_refine`` refines each of its frames; the verdicts and the
    merged corners match JAX's ``detect_batch`` on the same frames."""
    monkeypatch.setattr(bf_auto, "SHARED_CHUNK", 2)
    monkeypatch.setattr(jbf, "SHARED_CHUNK", 2)
    frames_np, gts = _frames()
    frames = torch.from_numpy(frames_np)
    grays, quads, scores = bf_auto._detect_prepare_batch(frames, RES)
    corners, oks = bf_auto._chunked_route(grays, quads, scores, 19, 2)
    assert oks.tolist() == [True, False]
    assert float(scores[3]) <= 0.55
    out, out_scores = bf_auto.detect_batch(frames)
    assert torch.equal(out_scores, scores)
    assert torch.equal(out[:2], corners[:2])
    for i in (2, 3):
        assert torch.equal(out[i], bf_auto._detect_refine(
            grays[i], quads[i], scores[i], 19))
    # The drifting frames come out right on either route (the saturated
    # 360p board is a hard case for the refine itself, in JAX too).
    assert np.abs(out[:3].numpy() - gts).max() < TOL_PX
    # No chunk validates → None, and detect_batch refines every frame.
    assert bf_auto._merge_routed(grays, quads, scores,
                                 list(corners.split(2)), np.zeros(2, bool),
                                 2, 19) is None

    # JAX's detect_batch on the same frames, its verdicts read where it
    # merges them.
    verdicts = []
    merge = jbf._merge_routed
    monkeypatch.setattr(jbf, "_merge_routed", lambda g, q, s, c, oks_host,
                        *a: verdicts.append(np.asarray(oks_host))
                        or merge(g, q, s, c, oks_host, *a))
    ref, ref_scores = jbf.detect_batch(jnp.asarray(frames_np))
    ref = np.asarray(ref)
    assert [v.tolist() for v in verdicts] == [oks.tolist()]
    np.testing.assert_allclose(out_scores.numpy(), np.asarray(ref_scores),
                               atol=1e-3)
    assert np.abs(out[:2].numpy() - ref[:2]).max() < 1.0
    assert np.abs(out[2:].numpy() - ref[2:]).max() < 0.5

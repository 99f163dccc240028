"""The reference's detection helpers that no other ported path calls,
against the JAX ones on the CPU from the same inputs: ``peak_lines`` /
``hough_lines`` (tests/test_bf_auto.py's two-line image and a board's
edge map), ``_coarse_quad`` and ``_refine_grid`` (``_rect_profiles`` +
``_fit_combs``) on a 480×854 board."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu.board import bf_auto as jbf
from camkifu_tpu.ops import hough as jhough
from camkifu_tpu.utils import synth
from camkifu_tpu_torch.board import bf_auto
from camkifu_tpu_torch.ops import hough

torch.set_num_threads(1)

#: The coarse stage on the same maps (tests/test_torch_detect.py's):
#: quad in px at 256², score.
COARSE_PX, COARSE_SCORE = 0.5, 1e-3

#: The comb fit on the same gray and quad: corners in px (the refine's
#: tests/test_torch_detect_refine.py tolerance), qualities.
COMB_PX, COMB_Q = 0.5, 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _two_lines():
    """tests/test_bf_auto.py's image: a horizontal line at y 40 and a
    vertical one at x 100."""
    img = np.zeros((128, 128), np.float32)
    img[40, :] = 1.0
    img[:, 100] = 1.0
    return img


def _board_edges():
    """The reference's edge map of an empty 480×854 board at 256²."""
    frame, _ = synth.render_frame(np.zeros((19, 19), np.int8),
                                  frame_hw=(480, 854), noise=0)
    gray = jnp.asarray(frame).astype(jnp.float32).mean(-1) / 255.0
    small = jax.image.resize(gray, (256, 256), method="bilinear")
    return np.asarray(jax.jit(jbf.edge_map, static_argnames="backend")(
        small, backend="xla"))


@pytest.mark.parametrize("image", ["two lines", "board edges"])
def test_peak_lines_and_hough_lines_match_jax(image):
    """``peak_lines`` on the reference's own accumulator: θ and the votes
    equal, ρ within 1e-3 px. ``hough_lines`` end to end: θ equal, ρ within
    1e-3 px, votes within 1e-4 relative of the strongest (the accumulators
    sum in another order); the two lines found at θ 0° / 90°, ρ 100 / 40,
    as tests/test_bf_auto.py finds them."""
    img = _two_lines() if image == "two lines" else _board_edges()
    k = 512 if image == "two lines" else 4096
    h, w = img.shape
    rho_max = float(np.hypot(h, w))
    pts, wts = jhough.topk_edge_points(jnp.asarray(img), k)
    acc = np.asarray(jhough.hough_accumulate(pts, wts, rho_max))
    th_j, rho_j, v_j = jhough.peak_lines(jnp.asarray(acc), rho_max)
    th, rho, v = hough.peak_lines(_t(acc), rho_max)
    assert np.array_equal(th.numpy(), np.asarray(th_j))
    assert np.array_equal(v.numpy(), np.asarray(v_j))
    assert np.abs(rho.numpy() - np.asarray(rho_j)).max() <= 1e-3

    th_j, rho_j, v_j = jhough.hough_lines(jnp.asarray(img), k=k)
    th, rho, v = hough.hough_lines(_t(img), k=k)
    assert th.shape == rho.shape == v.shape == (32,)
    assert np.array_equal(th.numpy(), np.asarray(th_j))
    assert np.abs(rho.numpy() - np.asarray(rho_j)).max() <= 1e-3
    assert np.abs(v.numpy() - np.asarray(v_j)).max() \
        <= 1e-4 * float(np.asarray(v_j).max())
    tb, rb, vb = hough.hough_lines(_t(np.stack([img, img])), k=k)
    assert torch.equal(tb[1], th) and torch.equal(vb[0], v)
    if image == "two lines":
        found = sorted(
            (round(np.degrees(a) - 180 if np.degrees(a) > 135
                   else np.degrees(a)),
             round(-b if np.degrees(a) > 135 else b))
            for a, b in zip(th.numpy()[:2], rho.numpy()[:2]))
        assert abs(found[0][0]) <= 2 and abs(found[0][1] - 100) <= 2
        assert abs(found[1][0] - 90) <= 2 and abs(found[1][1] - 40) <= 2


@functools.lru_cache(maxsize=1)
def _stage1_board():
    """A 480×854 ``synth`` board with 60 stones: the reference's uint8
    gray, its luma and chroma at 256², and its coarse quad in frame px."""
    labels = np.zeros((19, 19), np.int8)
    idx = np.random.default_rng(7).choice(361, 60, replace=False)
    labels.flat[idx[::2]] = 1
    labels.flat[idx[1::2]] = 2
    frame, corners = synth.render_frame(labels, frame_hw=(480, 854), seed=7)
    f = jnp.asarray(frame[None])
    with jax.default_matmul_precision("float32"):
        gray = jbf.rgb_to_gray_u8(f)
        small = jax.image.resize(gray.astype(jnp.float32) / 255.0,
                                 (1, 256, 256), method="bilinear")[0]
        chroma = jax.image.resize(
            (f[..., 0].astype(jnp.float32) - f[..., 2].astype(jnp.float32))
            / 255.0, (1, 256, 256), method="bilinear")[0]
    _, quad, _ = jbf._detect_prepare_batch(f, 256)
    return (np.asarray(gray[0]), np.asarray(small), np.asarray(chroma),
            np.asarray(quad[0]), corners)


@pytest.mark.parametrize("with_chroma", [True, False])
def test_coarse_quad_matches_jax(with_chroma):
    """The same luma (and chroma) at 256² into both ``_coarse_quad``s:
    quad within COARSE_PX, score within COARSE_SCORE; a board is found."""
    _, small, chroma, _, _ = _stage1_board()
    c = chroma if with_chroma else None
    quad_j, score_j = jax.jit(jbf._coarse_quad, static_argnames=(
        "edge_backend",))(jnp.asarray(small),
                          None if c is None else jnp.asarray(c),
                          edge_backend="xla")
    quad, score = bf_auto._coarse_quad(_t(small),
                                       None if c is None else _t(c))
    assert quad.shape == (4, 2) and score.shape == ()
    assert np.abs(quad.numpy() - np.asarray(quad_j)).max() <= COARSE_PX
    assert abs(float(score) - float(score_j)) <= COARSE_SCORE
    assert float(score) > 0.1


@pytest.mark.parametrize("gap_weight", [1.0, 0.0])
def test_refine_grid_matches_jax(gap_weight):
    """The reference's gray and coarse quad of a 480×854 board into both
    ``_refine_grid``s (``_rect_profiles`` + ``_fit_combs``): corners and
    the nine variants within COMB_PX, the comb quality and the variants'
    within COMB_Q; the central variant is the corners; the corners within
    tests/test_bf_auto.py's 11 px of the truth (the fit alone, no pin)."""
    gray, _, _, quad, truth = _stage1_board()
    refine = jax.jit(jbf._refine_grid, static_argnums=(2,),
                     static_argnames=("gap_weight",))
    ref = refine(jnp.asarray(gray), jnp.asarray(quad), 19,
                 gap_weight=gap_weight)
    ours = bf_auto._refine_grid(_t(gray), _t(quad), 19,
                                gap_weight=gap_weight)
    corners, q, vc, vq = ours
    assert vc.shape == (9, 4, 2) and vq.shape == (9,)
    assert torch.equal(vc[4], corners)
    for o, r, tol in zip(ours, ref, (COMB_PX, COMB_Q, COMB_PX, COMB_Q)):
        assert np.abs(o.numpy() - np.asarray(r)).max() <= tol
    assert np.abs(corners.numpy() - truth).max() < 11.0

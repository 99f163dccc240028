"""Detection on frames without a board, in both packages on the CPU: where
the port and the JAX reference part, and where they agree.

On a flat frame both packages compute the same gray (bitwise), then
resize it by two matmuls that sum in their own order, so the flat image
comes out a few ulp apart, differently in each. The edge map's thresholds
are relative to its own 99.5th percentile, so they turn that rounding
dust (gradients below 1e-6) into "edges", and what stage 1 finds there
(the reference a phantom quad, the port at 720p nothing) is made of the
dust. The stage after it is faithful: the port's ``_coarse_from_mag`` on
the reference's own edge maps gives the reference's quad and score. So
the first stage that differs is the resize's last bits, which no port can
match bit for bit (a recorded departure). On noise, where the edges are
real, both packages find no board.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu.board import bf_auto as jbf
from camkifu_tpu.ops.color import rgb_to_gray_u8 as jgray_u8
from camkifu_tpu.ops.edges import edge_map_batch as jedge_map_batch
from camkifu_tpu_torch.board import bf_auto
from camkifu_tpu_torch.ops.edges import edge_map_batch

torch.set_num_threads(1)

RES = 256
FLAT = 90
VALUE = np.float32(FLAT) / np.float32(255)
ULP = float(np.spacing(VALUE))

#: Each package's resized flat luma from the exact value, and the two from
#: each other, in ulp of 90/255 (measured: 2 and 1 ulp from it at
#: 720×1280, 3 and 3 at 480×854; 3 and 5 ulp apart).
RESIZE_ULPS = 3
PAIR_ULPS = 6

#: Edge magnitudes of a flat frame: rounding dust, six orders of magnitude
#: under a board's (measured 1.2e-7 and 3.4e-7 at most).
DUST = 1e-6


def _flat(hw):
    return np.full(hw + (3,), FLAT, np.uint8)


def _noise():
    rng = np.random.default_rng(0)
    return np.clip(FLAT + rng.normal(0, 8, (480, 854, 3)), 0,
                   255).astype(np.uint8)


def _jax_stage1_inputs(frame):
    """The reference's gray, resized luma and resized chroma at RES, as
    ``_detect_prepare_batch_impl`` computes them."""
    f = jnp.asarray(frame[None])
    with jax.default_matmul_precision("float32"):
        gray = jgray_u8(f)
        small = jax.image.resize(gray.astype(jnp.float32) / 255.0,
                                 (1, RES, RES), method="bilinear")
        chroma = jax.image.resize(
            (f[..., 0].astype(jnp.float32) - f[..., 2].astype(jnp.float32))
            / 255.0, (1, RES, RES), method="bilinear")
    return np.asarray(gray), np.asarray(small), np.asarray(chroma)


@pytest.mark.parametrize("hw", [(720, 1280), (480, 854)])
def test_flat_frames_part_at_the_resize(hw):
    """Stage by stage on a flat frame: gray u8 equal; the resized lumas
    each within RESIZE_ULPS of 90/255 and within PAIR_ULPS of each other,
    not equal; both edge maps dust (< DUST everywhere), the chroma maps
    zero; and the port's ``_coarse_from_mag`` on the reference's maps
    gives the reference's quad (0.05 px) and score (1e-5)."""
    frame = _flat(hw)
    gray_j, small_j, chroma_j = _jax_stage1_inputs(frame)
    ft = torch.from_numpy(frame[None])
    gray = bf_auto.rgb_to_gray_u8(ft)
    assert np.array_equal(gray.numpy(), gray_j)
    small = bf_auto.resize_bilinear(gray.to(torch.float32) / 255.0,
                                    (RES, RES))
    s, sj = small.numpy()[0], small_j[0]
    assert np.abs(s - VALUE).max() <= RESIZE_ULPS * ULP
    assert np.abs(sj - VALUE).max() <= RESIZE_ULPS * ULP
    assert 0 < np.abs(s - sj).max() <= PAIR_ULPS * ULP

    mags_j = np.asarray(jedge_map_batch(
        jnp.asarray(np.concatenate([small_j, chroma_j])), backend="xla"))
    chroma = bf_auto.resize_bilinear(
        (ft[..., 0].to(torch.float32) - ft[..., 2].to(torch.float32))
        / 255.0, (RES, RES))
    mags = edge_map_batch(torch.cat([small, chroma]))
    for m in (mags_j, mags.numpy()):
        assert m.max() < DUST and not m[1].any()

    quad_j, score_j = jbf._coarse_from_mag(jnp.asarray(mags_j[0]),
                                           jnp.asarray(mags_j[1]))
    quad, score = bf_auto._coarse_from_mag(torch.tensor(mags_j[0]),
                                           torch.tensor(mags_j[1]))
    assert abs(float(score) - float(score_j)) <= 1e-5
    assert np.abs(quad.numpy() - np.asarray(quad_j)).max() <= 0.05


def test_noise_frame_has_no_board_in_either_package():
    """A 480×854 frame of noise (σ 8 around 90, seed 0): ``detect_corners``
    scores under 0.2 in both packages (the reference's own bar,
    tests/test_bf_auto.py's no-board test) and stage 1 under 0.1 in both;
    the port's ``infer_gsize`` is (0, every candidate −1.0).

    The reference's ``infer_gsize`` is held through its stage 1: each of
    its ``_gsize_probe``s returns ``_detect_prepare``'s score, and a score
    under 0.1 makes the candidate −1.0, so a stage-1 score under 0.1 is
    the answer (0, every candidate −1.0) there too. Running it compiles a
    full detector per candidate (140 s on a CPU)."""
    frame = _noise()
    _, score_j = jbf.detect_corners(jnp.asarray(frame))
    stage1_j = np.asarray(jbf._detect_prepare_batch(
        jnp.asarray(frame[None]), 256)[2])
    ft = torch.from_numpy(frame)
    _, score = bf_auto.detect_corners(ft)
    assert float(score_j) < 0.2 and float(score) < 0.2
    assert stage1_j[0] < 0.1
    assert float(bf_auto._detect_prepare(ft, 256)[2]) < 0.1
    assert bf_auto.infer_gsize(ft) == (0, {9: -1.0, 13: -1.0, 19: -1.0})

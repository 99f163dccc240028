"""Each CUDA kernel against its plain PyTorch version on the card, at the
still path's shapes and at the batched detection's. Marked
``gpu``: where no CUDA device is present each test skips itself (decided in
the test body, never at import). Run on a GPU machine, which has no jax
for tests/conftest.py, with
``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest``."""

import numpy as np
import pytest
import torch

from camkifu_tpu_torch.ops.cuda import edge_kernel, hough_kernel, warp_kernel
from camkifu_tpu_torch.ops.warp import canonical_corners, homography_dlt
from camkifu_tpu_torch.utils.still import default_corners, render_still

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _frames(dev, n=4, hw=(720, 1280)):
    labels = np.zeros((19, 19), np.int8)
    labels[3, 3] = 1
    labels[15, 15] = 2
    frame, _ = render_still(labels, frame_hw=hw)
    return torch.from_numpy(frame).to(dev)[None].expand(n, *frame.shape) \
        .contiguous()


def test_warp_kernel_matches_plain():
    dev = _device()
    frames = _frames(dev)
    corners = torch.from_numpy(default_corners((720, 1280))).to(dev)
    H = homography_dlt(canonical_corners(device=dev), corners)
    for hm in (H, H.expand(4, 3, 3).contiguous()):
        ours = warp_kernel.warp_homography(frames, hm, (304, 304), 1 / 255)
        ref = warp_kernel.warp_homography_ref(frames, hm, (304, 304),
                                              1 / 255)
        torch.cuda.synchronize()
        assert float((ours - ref).abs().max()) <= 1e-3
    gray = frames[:1, :, :, :1].contiguous()
    ours = warp_kernel.warp_homography(gray, H, (320, 320))
    ref = warp_kernel.warp_homography_ref(gray, H, (320, 320))
    assert float((ours - ref).abs().max()) <= 1e-3 * 255
    # A degenerate homography samples NaN in both, with no fault.
    bad = torch.full((3, 3), float("nan"), device=dev)
    ours = warp_kernel.warp_homography(gray, bad, (8, 8))
    torch.cuda.synchronize()
    assert torch.isnan(ours).all()
    assert torch.isnan(warp_kernel.warp_homography_ref(gray, bad,
                                                       (8, 8))).all()


def test_edge_kernel_matches_plain():
    dev = _device()
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((3, 256, 256), generator=gen)
    x[1] = torch.linspace(0, 1, 256)[None, :] > 0.5
    x = x.to(dev)
    ours = edge_kernel.edge_magnitude(x)
    ref = edge_kernel.edge_magnitude_ref(x)
    torch.cuda.synchronize()
    b = edge_kernel.BORDER
    a, r = ours[:, b:-b, b:-b], ref[:, b:-b, b:-b]
    both = (a > 0) & (r > 0)
    assert float(both.sum()) >= 0.995 * float(((a > 0) | (r > 0)).sum())
    assert float((a - r)[both].abs().max()) <= 1e-4
    band = ours.clone()
    band[:, b:-b, b:-b] = 0
    assert float(band.abs().max()) == 0.0
    # Shapes that are not a multiple of the tile, and a single image.
    y = torch.rand((70, 45), generator=gen).to(dev)
    assert torch.allclose(edge_kernel.edge_magnitude(y),
                          edge_kernel.edge_magnitude_ref(y), atol=1e-4)


def test_hough_kernel_matches_plain():
    dev = _device()
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(0, 256, (4096, 2)).astype(np.float32))
    wts = torch.from_numpy(rng.uniform(0, 2, 4096).astype(np.float32))
    wts[::7] = 0
    pts, wts = pts.to(dev), wts.to(dev)
    rho_max = float(np.hypot(256, 256))
    ours = hough_kernel.hough_accumulate(pts, wts, rho_max, 128, 256)
    ref = hough_kernel.hough_accumulate_ref(pts, wts, rho_max, 128, 256)
    torch.cuda.synchronize()
    assert float((ours - ref).abs().max()) <= 1e-2


def test_edge_kernel_batch_of_128_matches_plain():
    """The batch grid at detect_batch's full-redetect shape: N = 128 maps
    (64 frames' luma and chroma), one launch."""
    dev = _device()
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((128, 256, 256), generator=gen)
    x[::3] = (torch.linspace(0, 1, 256)[None, None, :] > 0.3).float()
    x = x.to(dev)
    before = edge_kernel.launches
    ours = edge_kernel.edge_magnitude(x)
    assert edge_kernel.launches == before + 1
    ref = edge_kernel.edge_magnitude_ref(x)
    torch.cuda.synchronize()
    b = edge_kernel.BORDER
    a, r = ours[:, b:-b, b:-b], ref[:, b:-b, b:-b]
    both = (a > 0) & (r > 0)
    assert float(both.sum()) >= 0.995 * float(((a > 0) | (r > 0)).sum())
    assert float((a - r)[both].abs().max()) <= 1e-4
    assert float(ours[:, :b].abs().max()) == 0.0
    # Frame 127 is computed as on its own.
    one = edge_kernel.edge_magnitude(x[127].contiguous())
    assert torch.equal(one, ours[127])


def test_hough_kernel_batch_matches_plain():
    """A frame dimension on grid y: B = 64 accumulators in one launch,
    each the plain version of its own frame."""
    dev = _device()
    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.uniform(0, 256, (64, 4096, 2))
                           .astype(np.float32))
    wts = torch.from_numpy(rng.uniform(0, 2, (64, 4096)).astype(np.float32))
    wts[:, ::5] = 0
    pts, wts = pts.to(dev), wts.to(dev)
    rho_max = float(np.hypot(256, 256))
    before = hough_kernel.launches
    ours = hough_kernel.hough_accumulate(pts, wts, rho_max, 128, 256)
    assert hough_kernel.launches == before + 1
    assert ours.shape == (64, 128, 256)
    ref = hough_kernel.hough_accumulate_ref(pts, wts, rho_max, 128, 256)
    torch.cuda.synchronize()
    assert float((ours - ref).abs().max()) <= 1e-2
    single = hough_kernel.hough_accumulate(pts[5], wts[5], rho_max, 128, 256)
    assert float((single - ours[5]).abs().max()) <= 1e-2


def test_kernels_count_launches():
    dev = _device()
    before = (warp_kernel.launches, edge_kernel.launches,
              hough_kernel.launches)
    frames = _frames(dev, n=1)
    warp_kernel.warp_homography(frames, torch.eye(3, device=dev), (8, 8))
    edge_kernel.edge_magnitude(torch.zeros((32, 32), device=dev))
    hough_kernel.hough_accumulate(torch.zeros((4, 2), device=dev),
                                  torch.ones(4, device=dev), 10.0, 8, 16)
    after = (warp_kernel.launches, edge_kernel.launches,
             hough_kernel.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]


def _line_points(b: int, k: int = 4096, seed: int = 2):
    """(b, k, 2) points of which most lie on 38 board lines (19 each way,
    so ~100 points share each line's bin at its θ), the rest scattered,
    and (b, k) weights with every ninth zero."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 256, (b, k, 2)).astype(np.float32)
    on = int(k * 0.9)
    line = rng.integers(0, 38, (b, on))
    pos = (20.0 + 12.0 * (line % 19)).astype(np.float32)
    along = rng.uniform(20, 236, (b, on)).astype(np.float32)
    vertical = line < 19
    pts[:, :on, 0] = np.where(vertical, pos, along)
    pts[:, :on, 1] = np.where(vertical, along, pos)
    wts = rng.uniform(0.5, 2, (b, k)).astype(np.float32)
    wts[:, ::9] = 0
    return torch.from_numpy(pts), torch.from_numpy(wts)


@pytest.mark.parametrize("b", [1, 8, 64])
def test_hough_kernel_line_heavy_matches_plain(b):
    """Points crowded on a board's lines, so many votes share a bin, at
    the still (B = 1), film (B = 8) and redetect (B = 64) batches: on an
    H100 the first two split each frame's points across blocks, the
    redetect's does not."""
    dev = _device()
    pts, wts = _line_points(b)
    pts, wts = pts.to(dev), wts.to(dev)
    rho_max = float(np.hypot(256, 256))
    splits = hough_kernel.auto_splits(b, 4096, 128, dev)
    assert (splits > 1) == (b < 64)
    ref = hough_kernel.hough_accumulate_ref(pts, wts, rho_max, 128, 256)
    ours = hough_kernel.hough_accumulate(pts, wts, rho_max, 128, 256)
    torch.cuda.synchronize()
    assert float((ours - ref).abs().max()) <= 1e-2
    assert float(ref.max()) > 50.0          # the lines did pile up


@pytest.mark.parametrize("b", [1, 64])
def test_hough_kernel_wide_weights_keep_float32_precision(b):
    """Weights spread from 1e-4 to 1e2: every bin within float32 rounding
    of the plain version, relative to the magnitude of the votes it sums
    (the plain version on |weights|), with and without a split."""
    dev = _device()
    pts, _ = _line_points(b)
    rng = np.random.default_rng(3)
    wts = torch.from_numpy(
        (10.0 ** rng.uniform(-4, 2, (b, 4096))).astype(np.float32))
    pts, wts = pts.to(dev), wts.to(dev)
    rho_max = float(np.hypot(256, 256))
    ref = hough_kernel.hough_accumulate_ref(pts, wts, rho_max, 128, 256)
    mag = hough_kernel.hough_accumulate_ref(pts, wts.abs(), rho_max, 128, 256)
    ours = hough_kernel.hough_accumulate(pts, wts, rho_max, 128, 256)
    torch.cuda.synchronize()
    assert bool(((ours - ref).abs() <= 1e-5 * mag + 1e-9).all())
    # Signed weights add as they do in the plain version.
    wts[:, ::2] *= -1
    ref = hough_kernel.hough_accumulate_ref(pts, wts, rho_max, 128, 256)
    ours = hough_kernel.hough_accumulate(pts, wts, rho_max, 128, 256)
    torch.cuda.synchronize()
    assert bool(((ours - ref).abs() <= 1e-5 * mag + 1e-9).all())


def test_hough_kernel_odd_rows_and_bins():
    """θ rows and ρ bins that are not multiples of 32, split (B = 3) and
    not (B = 64 at 100 rows, on an H100), and the widest n_ρ."""
    dev = _device()
    seen = set()
    for b, n_theta, n_rho in ((3, 45, 100), (3, 7, 33), (64, 100, 100),
                              (2, 40, hough_kernel.MAX_RHOS)):
        pts, wts = _line_points(b, k=1000)
        pts, wts = pts.to(dev), wts.to(dev)
        seen.add(hough_kernel.auto_splits(b, 1000, n_theta, dev) > 1)
        ref = hough_kernel.hough_accumulate_ref(pts, wts, 300.0, n_theta,
                                                n_rho)
        ours = hough_kernel.hough_accumulate(pts, wts, 300.0, n_theta, n_rho)
        torch.cuda.synchronize()
        assert float((ours - ref).abs().max()) <= 1e-2
    assert seen == {False, True}
    with pytest.raises(ValueError):
        hough_kernel.hough_accumulate(pts, wts, 300.0, 8,
                                      hough_kernel.MAX_RHOS + 1)


@pytest.mark.parametrize("c, out_hw", [(3, (301, 303)), (1, (320, 320)),
                                       (1, (97, 61)), (2, (50, 77))])
def test_warp_kernel_bitwise_at_odd_shapes(c, out_hw):
    """Odd output widths (the ragged end and rows that are not 16-byte
    aligned store float by float), one channel, and a channel count the
    word loads do not take: bitwise equal to the plain version."""
    dev = _device()
    frames = _frames(dev, n=3, hw=(719, 1277))[..., :c].contiguous()
    corners = torch.from_numpy(default_corners((719, 1277))).to(dev)
    H = homography_dlt(canonical_corners(device=dev), corners)
    for hm in (H, H.expand(3, 3, 3).contiguous()):
        ours = warp_kernel.warp_homography(frames, hm, out_hw, 1 / 255)
        ref = warp_kernel.warp_homography_ref(frames, hm, out_hw, 1 / 255)
        torch.cuda.synchronize()
        assert torch.equal(ours, ref)

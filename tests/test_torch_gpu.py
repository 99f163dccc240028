"""Each CUDA kernel against its plain PyTorch version on the card, at the
still path's shapes and at the batched detection's. Marked
``gpu``: where no CUDA device is present each test skips itself (decided in
the test body, never at import). Run on a GPU machine, which has no jax
for tests/conftest.py, with
``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest``."""

import numpy as np
import pytest
import torch

from camkifu_tpu_torch.ops.cuda import edge_kernel, hough_kernel, \
    hysteresis_kernel, warp_kernel
from camkifu_tpu_torch.ops.warp import canonical_corners, homography_dlt, \
    square
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


def _edge_input(shape, seed):
    """Noise with a step edge in every third map (or in a lone map)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(shape, generator=gen)
    step = (torch.linspace(0, 1, shape[-1]) > 0.3).float()
    if len(shape) == 3:
        x[::3] = 0.8 * step + 0.2 * x[::3]
    else:
        x = 0.8 * step + 0.2 * x
    return x


@pytest.mark.parametrize("shape", [
    (1, 256, 256), (2, 256, 256), (16, 256, 256), (128, 256, 256), (70, 45),
    (3, 17, 300), (2, 300, 17), (2, 40, 500), (3, 64, 257), (2, 15, 64),
    (2, 64, 12), (1, 16, 16)])
def test_edge_kernel_bitwise_equal_to_plain(shape):
    """The path's batches, shapes that no strip or segment divides, rows
    that are not 16-byte aligned, a width of more than two strips, and maps
    under 2 * BORDER a side (all zeros): ``torch.equal`` in the interior,
    zeros in the band, one launch."""
    dev = _device()
    x = _edge_input(shape, seed=len(shape) * 1000 + shape[-1]).to(dev)
    before = edge_kernel.launches
    ours = edge_kernel.edge_magnitude(x)
    assert edge_kernel.launches == before + 1
    ref = edge_kernel.edge_magnitude_ref(x)
    torch.cuda.synchronize()
    assert ours.shape == x.shape
    assert torch.equal(ours, ref)
    b = edge_kernel.BORDER
    if min(shape[-2:]) > 2 * b:
        assert float(ours[..., b:-b, b:-b].max()) > 0.0
    else:
        assert float(ours.abs().max()) == 0.0


@pytest.mark.parametrize("cols", [4, 8])
def test_edge_kernel_strip_widths_and_segment_lengths_agree(cols):
    """Both strip widths at every segment length give the plain version's
    map: the C entry point at 1 to H rows a segment, on a map wider than
    two narrow strips, and on rows that start off 16-byte boundaries."""
    dev = _device()
    from camkifu_tpu_torch.ops.cuda import _build

    x = _edge_input((3, 100, 260), seed=5).to(dev)
    ref = edge_kernel.edge_magnitude_ref(x)
    assert torch.equal(edge_kernel.edge_magnitude(x), ref)
    lib, taps = edge_kernel._ready(1.4)
    y = torch.zeros(3 * 100 * 260 + 1, device=dev)[1:].view(3, 100, 260)
    y.copy_(x)
    for rows in (1, 3, 4, 13, 64, 99, 100, 1000):
        for src in (x, y):
            out = torch.full_like(x, -1.0)
            _build.check(lib.camkifu_edge(
                src.data_ptr(), out.data_ptr(), 3, 100, 260,
                edge_kernel.BORDER, cols, rows, taps,
                _build.stream_handle(dev)), "edge")
            torch.cuda.synchronize()
            assert torch.equal(out, ref), rows
    z = _edge_input((2, 40, 1000), seed=6).to(dev)
    out = torch.empty_like(z)
    _build.check(lib.camkifu_edge(
        z.data_ptr(), out.data_ptr(), 2, 40, 1000, edge_kernel.BORDER, cols,
        7, taps, _build.stream_handle(dev)), "edge")
    assert torch.equal(out, edge_kernel.edge_magnitude_ref(z))


def test_edge_kernel_plan_follows_the_batch():
    """Narrow strips and short segments for a pair of maps, wide strips and
    long segments for the redetect's 128 (on an H100's 132 SMs)."""
    dev = _device()
    plans = [edge_kernel.auto_plan(n, 256, 256, dev) for n in (2, 16, 128)]
    assert [p[0] for p in plans] == [4, 8, 8]
    assert plans[0][1] <= plans[1][1] <= plans[2][1]
    assert all(1 <= rows <= 256 for _, rows in plans)


def _hysteresis_input(shape, seed):
    gen = torch.Generator().manual_seed(seed)
    mag = torch.rand(shape, generator=gen)
    return mag * (torch.rand(shape, generator=gen) < 0.45)


@pytest.mark.parametrize("iters", [0, 1, 4, 8])
@pytest.mark.parametrize("shape", [
    (1, 256, 256), (2, 256, 256), (16, 256, 256), (128, 256, 256), (70, 45),
    (3, 17, 300), (2, 300, 17), (2, 40, 500), (2, 5, 3)])
def test_hysteresis_kernel_equals_plain(shape, iters):
    """``torch.equal`` with the plain version at the path's batches and at
    shapes that no tile divides or that the halo wraps around, thresholds
    as floats and as one pair a map on the device; one launch."""
    dev = _device()
    mag = _hysteresis_input(shape, seed=shape[-1] + iters).to(dev)
    before = hysteresis_kernel.launches
    ours = hysteresis_kernel.hysteresis(mag, 0.3, 0.8, iters)
    assert hysteresis_kernel.launches == before + 1
    ref = hysteresis_kernel.hysteresis_ref(mag, 0.3, 0.8, iters)
    torch.cuda.synchronize()
    assert torch.equal(ours, ref)
    if ours.numel() > 1000:
        assert 0 < int((ours > 0).sum()) < ours.numel()
    if len(shape) == 3:
        n = shape[0]
        low = torch.linspace(0.2, 0.45, n, device=dev)[:, None, None]
        high = torch.linspace(0.95, 0.6, n, device=dev)[:, None, None]
        ours = hysteresis_kernel.hysteresis(mag, low, high, iters)
        ref = hysteresis_kernel.hysteresis_ref(mag, low, high, iters)
        assert torch.equal(ours, ref)
        # One tensor for all maps, and a float beside a tensor.
        ours = hysteresis_kernel.hysteresis(mag, low[0], 0.8, iters)
        ref = hysteresis_kernel.hysteresis_ref(mag, low[0], 0.8, iters)
        assert torch.equal(ours, ref)


def test_hysteresis_kernel_wraps_and_handles_zero_and_nan():
    dev = _device()
    mag = torch.zeros((2, 64, 200), device=dev)
    assert float(hysteresis_kernel.hysteresis(mag, 0.3, 0.8, 4).abs().max()) \
        == 0.0
    # The only strong pixel on row 0, weak pixels on the last rows and in
    # the last column.
    mag[0, 0, 5] = 0.9
    mag[0, -3:, 3:8] = 0.5
    mag[0, 0:2, -1] = 0.5
    mag[0, 1, 0] = 0.5
    mag[1, 10, 10] = float("nan")
    mag[1, 10, 11] = 0.9
    for iters in (0, 1, 4, 8):
        ours = hysteresis_kernel.hysteresis(mag, 0.3, 0.8, iters)
        ref = hysteresis_kernel.hysteresis_ref(mag, 0.3, 0.8, iters)
        assert torch.equal(ours, ref)
        assert bool(ours[0, -1, 5] > 0) == (iters >= 1)
        assert float(ours[1, 10, 10]) == 0.0
    nan = torch.full((2, 1, 1), float("nan"), device=dev)
    ours = hysteresis_kernel.hysteresis(mag, nan, nan, 4)
    assert float(ours.abs().max()) == 0.0
    with pytest.raises(ValueError):
        hysteresis_kernel.hysteresis(mag, 0.3, 0.8,
                                     hysteresis_kernel.MAX_ITERS + 1)


def test_edge_map_batch_takes_both_kernels():
    """``edge_map_batch`` on the card is one edge launch and one hysteresis
    launch, and equals the plain hysteresis of the kernel's magnitudes."""
    dev = _device()
    from camkifu_tpu_torch.ops import edges

    x = _edge_input((4, 256, 256), seed=11).to(dev)
    before = (edge_kernel.launches, hysteresis_kernel.launches)
    ours = edges.edge_map_batch(x)
    after = (edge_kernel.launches, hysteresis_kernel.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1]
    mags = edge_kernel.edge_magnitude_ref(x)
    ref = edges.percentile(mags[:, ::2, ::2].reshape(4, -1), 99.5,
                           dim=1)[:, None, None]
    assert torch.equal(ours, hysteresis_kernel.hysteresis_ref(
        mags, 0.15 * ref, 0.4 * ref, 4))


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


@pytest.mark.parametrize("shape", ["fused canvas", "gray canvas", "chunked"])
def test_warp_kernel_equals_plain_at_the_tracker_shapes(shape):
    """The handheld path's three warps at 1080p: the fused engine's canvas
    (16 frames RGB → 336²), the unfused tracker's gray canvas (8 frames →
    320²), ``warp_batch_chunked``'s chunk (8 frames RGB → 304²)."""
    from camkifu_tpu_torch.board import bf_auto

    dev = _device()
    hw = (1080, 1920)
    corners = torch.from_numpy(default_corners(hw)).to(dev) + 1.75
    if shape == "fused canvas":
        frames = _frames(dev, 16, hw)
        H = homography_dlt(square(23.5, 311.5, dev), corners)
        out_hw = (336, 336)
    elif shape == "gray canvas":
        frames = _frames(dev, 8, hw)[..., 1:2].contiguous()
        H = bf_auto._rect_H(corners, bf_auto.TRACK_MARGIN, 320)
        out_hw = (320, 320)
    else:
        frames = _frames(dev, 8, hw)
        H = homography_dlt(canonical_corners(device=dev), corners)
        out_hw = (304, 304)
    H = H.contiguous()
    before = warp_kernel.launches
    ours = warp_kernel.warp_homography(frames, H, out_hw, 1 / 255)
    assert warp_kernel.launches == before + 1
    ref = warp_kernel.warp_homography_ref(frames, H, out_hw, 1 / 255)
    torch.cuda.synchronize()
    assert torch.equal(ours, ref)


def test_track_read_batch_on_the_card_matches_the_cpu_and_never_waits():
    """32 frames of a drifting 720p board: the card and ``device="cpu"``
    agree (corners within 0.5 px, labels equal), the warp kernel runs once
    a chunk, and on a warm second call every synchronizing call is an
    error: there is none."""
    from camkifu_tpu_torch.stone import sf_meta
    from camkifu_tpu_torch.utils.still import handheld_corners

    dev = _device()
    hw = (720, 1280)
    labels = np.zeros((19, 19), np.int8)
    labels[3, 3] = 1
    labels[15, 15] = 2
    truth = handheld_corners(32, hw)
    frames = np.stack([render_still(labels, hw, seed=t, corners=c)[0]
                       for t, c in enumerate(truth)])
    fb, seed = torch.from_numpy(frames), torch.from_numpy(truth[0])
    out_c = sf_meta.track_read_batch(sf_meta.init_state(device="cpu"), fb,
                                     seed)
    state0 = sf_meta.init_state()
    assert state0.votes.is_cuda                  # the default device
    fb_d, seed_d = fb.to(dev), seed.to(dev)
    before = warp_kernel.launches
    out_d = sf_meta.track_read_batch(state0, fb_d, seed_d)
    assert warp_kernel.launches == before + 2    # 32 frames, 16 a chunk
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = sf_meta.track_read_batch(state0, fb_d, seed_d, valid_count=30)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(t.is_cuda for t in out_d[1:])
    assert torch.equal(out_d[1].cpu(), out_c[1])
    assert torch.equal(again[1][:30], out_d[1][:30])
    assert float((out_d[4].cpu() - out_c[4]).abs().max()) < 0.5
    assert float((out_d[7].cpu() - out_c[7]).abs().max()) < 0.5
    cell = float(np.linalg.norm(truth[0][1] - truth[0][0]) / 18)
    assert np.abs(out_d[4].cpu().numpy() - truth).max() < 0.15 * cell
    assert int(out_d[1][-1].ne(0).sum()) == 2    # both stones committed


def test_unfused_tracker_and_chunked_warp_on_the_card_match_the_cpu():
    from camkifu_tpu_torch.board import bf_auto
    from camkifu_tpu_torch.ops.warp import warp_batch_chunked
    from camkifu_tpu_torch.utils.still import handheld_corners

    dev = _device()
    hw = (720, 1280)
    labels = np.zeros((19, 19), np.int8)
    labels[9, 9] = 1
    truth = handheld_corners(12, hw)
    frames = np.stack([render_still(labels, hw, seed=t, corners=c)[0]
                       for t, c in enumerate(truth)])
    fb, seed = torch.from_numpy(frames), torch.from_numpy(truth[0])
    cs_c, sharp_c, _, _ = bf_auto.track_corners_batch(fb, seed)
    before = warp_kernel.launches
    cs_d, sharp_d, _, _ = bf_auto.track_corners_batch(fb.to(dev),
                                                      seed.to(dev))
    assert warp_kernel.launches == before + 2    # 12 frames, 8 a chunk
    assert float((cs_d.cpu() - cs_c).abs().max()) < 0.5
    assert torch.allclose(sharp_d.cpu(), sharp_c, rtol=1e-3)
    canon_c = warp_batch_chunked(fb, cs_c, scale=1 / 255)
    canon_d = warp_batch_chunked(fb.to(dev), cs_c.to(dev), scale=1 / 255)
    assert canon_d.shape == (12, 304, 304, 3)
    assert float((canon_d.cpu() - canon_c).abs().max()) < 1e-4


def test_warp_kernel_with_a_homography_per_frame_equals_plain():
    """c5's launch: 8 streams × 4 frames, every frame through its own
    homography (its stream's corners moved by a hundredth of a pixel a
    frame): bitwise equal to the plain version, one launch."""
    dev = _device()
    hw = (1080, 1920)
    frames = _frames(dev, 32, hw)
    base = torch.from_numpy(default_corners(hw)).to(dev)
    shift = torch.arange(32, device=dev, dtype=torch.float32)
    corners = base + (shift // 4 * 5.0 + shift * 0.01)[:, None, None]
    H = homography_dlt(canonical_corners(device=dev), corners).contiguous()
    before = warp_kernel.launches
    ours = warp_kernel.warp_homography(frames, H, (304, 304), 1 / 255)
    assert warp_kernel.launches == before + 1
    ref = warp_kernel.warp_homography_ref(frames, H, (304, 304), 1 / 255)
    torch.cuda.synchronize()
    assert torch.equal(ours, ref)


def test_multistream_track_read_on_the_card_never_waits():
    """Three drifting 720p streams of 16 frames: one warp launch for all
    of them, a warm call with every synchronizing call an error, and each
    stream's labels equal to the single-stream engine's on the card,
    corners within 1e-3 px."""
    from camkifu_tpu_torch.parallel import mesh
    from camkifu_tpu_torch.stone import sf_meta
    from camkifu_tpu_torch.utils.still import handheld_corners

    dev = _device()
    hw = (720, 1280)
    labels = np.zeros((19, 19), np.int8)
    labels[3, 3] = 1
    labels[15, 15] = 2
    frames, seeds = [], []
    for s in range(3):
        truth = handheld_corners(16, hw) + np.float32(6 * s - 6)
        frames.append(np.stack([render_still(labels, hw, seed=t, corners=c)[0]
                                for t, c in enumerate(truth)]))
        seeds.append(truth[0])
    fb = torch.from_numpy(np.stack(frames)).to(dev)
    sd = torch.from_numpy(np.stack(seeds)).to(dev)
    states = mesh.multistream_init_states(3)
    assert states.votes.is_cuda and states.frame_count.shape == (3,)
    before = warp_kernel.launches
    out = mesh.multistream_track_read(states, fb, sd)
    assert warp_kernel.launches == before + 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = mesh.multistream_track_read(states, fb, sd)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(again[1], out[1])
    for s in range(3):
        one = sf_meta.track_read_batch(sf_meta.init_state(), fb[s], sd[s])
        assert torch.equal(one[1], out[1][s])
        assert float((one[4] - out[4][s]).abs().max()) <= 1e-3


@pytest.mark.parametrize("case", ["undistort 1080p", "rect 513 gray",
                                  "canvas shared", "canvas a lens a frame"])
def test_warp_kernel_lens_mode_bitwise_equal_to_plain(case):
    """The warp's lens mode at the lens paths' shapes: a 1080p frame
    undistorted (identity homography), the known-corner calibration's 513²
    gray rect, the tracker's 336² canvas with one shared lens and with a
    lens a frame (two streams of 4 frames, k1 = 0.06 and −0.04): bitwise
    equal to the plain version, one launch each."""
    from camkifu_tpu_torch.ops import lens as L

    dev = _device()
    hw = (1080, 1920)
    lens = L.make_lens(0.06, hw)
    corners = torch.from_numpy(default_corners(hw)).to(dev)
    if case == "undistort 1080p":
        frames = _frames(dev, 1, hw)
        H, out_hw = torch.eye(3, device=dev), hw
    elif case == "rect 513 gray":
        frames = _frames(dev, 1, hw)[..., 1:2].contiguous()
        H = homography_dlt(canonical_corners(19, 27, dev),
                           L.undistort_pts(lens, corners))
        out_hw = (513, 513)
    else:
        frames = _frames(dev, 8, hw)
        H = homography_dlt(square(23.5, 311.5, dev),
                           L.undistort_pts(lens, corners))
        out_hw = (336, 336)
        if case == "canvas a lens a frame":
            two = L.stack_lenses([lens, L.make_lens(-0.04, hw)], dev)
            lens = L.as_table(two)[:, None].expand(2, 4, 5).reshape(8, 5) \
                .contiguous()
    H = H.contiguous()
    args = (frames, H, out_hw, 1 / 255,
            lens if isinstance(lens, torch.Tensor) else tuple(lens))
    before = warp_kernel.launches
    ours = warp_kernel.warp_homography(*args)
    assert warp_kernel.launches == before + 1
    ref = warp_kernel.warp_homography_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(ours, ref)
    if case == "undistort 1080p":
        got = L.undistort_frame(frames[0], L.make_lens(0.06, hw))
        want = torch.clamp(ref[0] * 255 + 0.5, 0, 255).to(torch.uint8)
        assert got.dtype == torch.uint8
        assert int((got.int() - want.int()).abs().max()) <= 1
    # The lens moves the samples: the lens-free warp reads other values.
    plain = warp_kernel.warp_homography(frames, H, out_hw, 1 / 255)
    assert not torch.equal(plain, ours)
    assert torch.equal(plain, warp_kernel.warp_homography_ref(
        frames, H, out_hw, 1 / 255))


def test_lens_track_read_batch_on_the_card_never_waits():
    """A drifting 720p board through a k1 = 0.06 lens: ``track_read_batch``
    with the lens on the card agrees with ``device="cpu"`` (corners within
    0.5 px, labels equal), lands within 0.15 cell of the truth, launches
    the warp once a chunk, and a warm call with every synchronizing call
    an error has none."""
    from camkifu_tpu_torch.ops import lens as L
    from camkifu_tpu_torch.stone import sf_meta
    from camkifu_tpu_torch.utils.still import handheld_corners

    dev = _device()
    hw = (720, 1280)
    labels = np.zeros((19, 19), np.int8)
    labels[3, 3] = 1
    labels[15, 15] = 2
    pin = handheld_corners(16, hw)
    out = [render_still(labels, hw, seed=t, corners=c, lens_k1=0.06)
           for t, c in enumerate(pin)]
    frames = np.stack([f for f, _ in out])
    truth = np.stack([c for _, c in out])
    lens = L.make_lens(0.06, hw)
    fb, seed = torch.from_numpy(frames), torch.from_numpy(truth[0])
    out_c = sf_meta.track_read_batch(sf_meta.init_state(device="cpu"), fb,
                                     seed, lens=lens)
    state0 = sf_meta.init_state()
    fb_d, seed_d = fb.to(dev), seed.to(dev)
    before = warp_kernel.launches
    out_d = sf_meta.track_read_batch(state0, fb_d, seed_d, lens=lens)
    assert warp_kernel.launches == before + 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = sf_meta.track_read_batch(state0, fb_d, seed_d, lens=lens)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(again[1], out_d[1])
    assert torch.equal(out_d[1].cpu(), out_c[1])
    assert float((out_d[4].cpu() - out_c[4]).abs().max()) < 0.5
    cell = float(np.linalg.norm(truth[0][1] - truth[0][0]) / 18)
    assert np.abs(out_d[4].cpu().numpy() - truth).max() < 0.15 * cell


def test_one_camera_and_a_stacked_lens_take_the_same_bits_on_the_card():
    """On the card a lens of Python numbers goes through tensors (the card
    divides by a Python number through its reciprocal): a camera's points
    distorted and undistorted alone equal its row of a stacked lens, bit
    for bit, as the stream tracker needs."""
    from camkifu_tpu_torch.ops import lens as L

    dev = _device()
    hw = (720, 1280)
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.uniform([0, 0], [1280, 720], (2, 64, 2))
                           .astype(np.float32)).to(dev)
    one = L.make_lens(0.06, hw)
    both = L.stack_lenses([one, L.make_lens(-0.04, hw)], dev)
    for fn in (L.distort_pts, L.undistort_pts):
        assert torch.equal(fn(one, pts[0]), fn(both, pts)[0])


def test_device_feeder_batches_equal_the_frames_bitwise():
    """The CUDA-stream feeder over 3× its pinned ring (and a padded tail):
    each batch, copied on the consumer's stream behind a device spin and
    then dropped, equals its frames bit for bit. A pinned slot refilled
    before its copy finished, a consumer stream that does not wait for the
    copy, or a batch's memory reused while that stream still reads it
    would each change a batch."""
    from camkifu_tpu_torch.core.capture import ArrayCapture, pad_batch
    from camkifu_tpu_torch.core.feeder import DeviceFeeder

    dev = _device()
    depth, batch = 2, 8
    n_batches = 3 * (depth + 1) + 1
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (n_batches * batch - 3, 360, 640, 3),
                          dtype=np.uint8)
    feeder = DeviceFeeder(ArrayCapture(list(frames)), batch, depth=depth,
                          device=dev)
    kept, meta = [], []
    try:
        for dev_frames, n, done, last, _arrivals in feeder:
            torch.cuda._sleep(20_000_000)          # the consumer is busy
            kept.append(dev_frames.clone())        # queued behind the spin
            meta.append((n, done, last))
            del dev_frames
    finally:
        feeder.close()
    assert len(kept) == n_batches
    for i, (got, (n, done, last)) in enumerate(zip(kept, meta)):
        want, k = pad_batch(frames[i * batch:(i + 1) * batch], batch)
        assert (n, done) == (k, i == n_batches - 1)
        assert got.is_cuda and torch.equal(got.cpu(), torch.from_numpy(want))
        assert np.array_equal(last, want[n - 1])


def test_runtime_steady_batch_reads_the_host_once():
    """A warm steady tracked batch of the runtime (VManagerSeq,
    BoardFinderAuto, SfMeta; no detection) with every synchronizing call
    an error: the one batched host read (``core.feeder.host_read``, an
    event wait) is its only wait."""
    from camkifu_tpu_torch.board.bf_auto import BoardFinderAuto
    from camkifu_tpu_torch.core.capture import ArrayCapture
    from camkifu_tpu_torch.core.controllerv import ControllerVSeq
    from camkifu_tpu_torch.core.vmanager import VManagerSeq
    from camkifu_tpu_torch.stone import sf_meta
    from camkifu_tpu_torch.utils.still import (handheld_corners,
                                                render_game, sample_moves)

    dev = _device()
    hw = (720, 1280)
    frames, _ = render_game(sample_moves(3, seed=5), 12, frame_hw=hw,
                            seed=5, empty_leadin=12,
                            corners=handheld_corners(48, hw), workers=8)
    vm = VManagerSeq(ControllerVSeq(), video=None,
                     bf_class=BoardFinderAuto, sf_class=sf_meta.SfMeta,
                     batch=16)
    assert vm.device.type == "cuda"              # the default device
    vm.capture = ArrayCapture(list(frames))
    vm.instantiate_finders()
    vm.board_finder._lens_checked = True
    vm.run(max_batches=2)                        # the anchor, one tracked
    assert vm.board_finder.track_seed.is_cuda
    reads = []
    host_read = sf_meta.host_read

    def counted(*tensors):
        reads.append(len(tensors))
        return host_read(*tensors)

    sf_meta.host_read = counted
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        vm.run(max_batches=1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        sf_meta.host_read = host_read
    assert reads == [6]
    assert vm.board_finder._since_detect == 2
    assert vm.board_finder.corners_batch.shape == (16, 4, 2)
    assert vm.stones_finder.state.votes.is_cuda


def _f32_grads(model, x, y):
    """Per parameter, the gradient of the same net computed in float32
    throughout, on the CPU."""
    import torch.nn.functional as F

    from camkifu_tpu_torch.models import neural

    twin = neural.params_from_jax(neural.params_to_jax(model), device="cpu")
    h = x.permute(0, 3, 1, 2)
    for conv in (twin.Conv_0, twin.Conv_1):
        h = F.avg_pool2d(F.relu(F.conv2d(h, conv.weight, conv.bias,
                                         padding=1)), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(F.linear(h, twin.Dense_0.weight, twin.Dense_0.bias))
    F.cross_entropy(F.linear(h, twin.Dense_1.weight, twin.Dense_1.bias),
                    y).backward()
    return [p.grad for p in twin.parameters()]


def test_train_step_on_the_card_matches_the_cpu():
    """One AdamW step of PatchNet from the same parameters and batch on the
    card (bf16 through cuDNN and cuBLAS, deterministic algorithms) and on
    the CPU: losses within 1e-2 relative, and every gradient within 0.06
    relative L2 of the float32 net's on both."""
    from camkifu_tpu_torch.models import neural

    dev = _device()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((1444, 16, 16, 3), np.float32))
    y = torch.from_numpy(rng.integers(0, 3, 1444))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for d in ("cpu", dev):
            model = neural.init_params(torch.Generator().manual_seed(0),
                                       device=d)
            opt = neural.make_optimizer(model)
            loss, acc = neural.train_step(model, opt, x.to(d), y.to(d))
            runs.append((float(loss), [p.grad.cpu() for p in
                                       model.parameters()], model))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert runs[1][2].Conv_0.weight.is_cuda
    assert runs[1][0] == pytest.approx(runs[0][0], rel=1e-2)
    ref = _f32_grads(neural.init_params(torch.Generator().manual_seed(0),
                                        device="cpu"), x, y)
    for _, grads, _ in runs:
        for g, r in zip(grads, ref):
            assert float((g - r).norm() / r.norm()) <= 0.06


def _trained_net(dev):
    from camkifu_tpu_torch.models import neural

    patches, labels = neural.harvest_patches(n_boards=6, frame_hw=(480, 854),
                                             seed=3, device=dev)
    model, acc = neural.train(patches, labels, epochs=4, batch=512)
    assert acc > 0.97
    return model


def _still_game(moves=4, hw=(360, 640)):
    from camkifu_tpu_torch.config import cvconf
    from camkifu_tpu_torch.utils.still import render_game, sample_moves

    frames, corners = render_game(sample_moves(moves, seed=12),
                                  cvconf.vote_window + 3, frame_hw=hw,
                                  empty_leadin=5)
    return frames[:32], corners


def test_classify_and_bgsub_on_the_card_match_the_cpu():
    """``classify_batch_neural`` (a net trained on the card) and
    ``sf_bgsub.read_batch`` over 32 frames of a game, card against
    ``device="cpu"``: labels equal (the net's where the CPU's top-2 margin
    exceeds 0.02), confidences within 3e-3, the background within 1e-4
    (the homography solves round differently), one warp launch each."""
    from camkifu_tpu_torch.models import neural
    from camkifu_tpu_torch.ops.warp import warp_batch_fixed
    from camkifu_tpu_torch.stone import sf_bgsub, sf_neural

    dev = _device()
    model = _trained_net(dev)
    frames, corners = _still_game()
    fb, cs = torch.from_numpy(frames), torch.from_numpy(corners)
    cpu_net = neural.params_from_jax(neural.params_to_jax(model), "cpu")
    before = warp_kernel.launches
    lab_d, conf_d = sf_neural.classify_batch_neural(model, fb.to(dev),
                                                    cs.to(dev))
    assert warp_kernel.launches == before + 1
    lab_c, conf_c = sf_neural.classify_batch_neural(cpu_net, fb, cs)
    probs = sf_neural.zone_probs(cpu_net, warp_batch_fixed(fb, cs,
                                                           scale=1 / 255))
    top2 = torch.sort(probs, dim=-1).values[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 0.02
    assert torch.equal(lab_d.cpu()[clear], lab_c[clear])
    assert float((conf_d.cpu() - conf_c).abs().max()) <= 3e-3

    before = warp_kernel.launches
    out_d = sf_bgsub.read_batch(sf_bgsub.init_state(), fb.to(dev), cs.to(dev),
                                valid_count=30)
    assert warp_kernel.launches == before + 1
    out_c = sf_bgsub.read_batch(sf_bgsub.init_state(device="cpu"), fb, cs,
                                valid_count=30)
    for name in ("votes", "stable", "frame_count"):
        assert torch.equal(getattr(out_d[0], name).cpu(),
                           getattr(out_c[0], name)), name
    assert float((out_d[0].bg.cpu() - out_c[0].bg).abs().max()) <= 1e-4
    assert torch.equal(out_d[1].cpu(), out_c[1])
    assert float((out_d[2].cpu() - out_c[2]).abs().max()) <= 1e-4
    assert int(out_d[1][29].ne(0).sum()) >= 1


def test_finders_with_the_net_never_wait():
    """Warm ``sf_bgsub.read_batch``, ``classify_batch_neural`` and
    ``sf_meta.read_batch`` with the neural voter, every synchronizing call
    an error: there is none."""
    from camkifu_tpu_torch.stone import sf_bgsub, sf_meta, sf_neural

    dev = _device()
    model = _trained_net(dev)
    frames, corners = _still_game()
    fb, cs = torch.from_numpy(frames).to(dev), torch.from_numpy(corners) \
        .to(dev)
    calls = (
        lambda: sf_bgsub.read_batch(sf_bgsub.init_state(device=dev), fb, cs,
                                    valid_count=30),
        lambda: sf_neural.classify_batch_neural(model, fb, cs),
        lambda: sf_meta.read_batch(sf_meta.init_state(device=dev), fb, cs,
                                   neural_params=model, valid_count=30))
    for call in calls:
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [call() for call in calls]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(o[1].is_cuda for o in (outs[0], outs[2]))


SYNTH_GROUPS = [
    {},
    dict(stone_jitter=0.07, light_gradient=0.3, blur_sigma=1.2, shadow=0.18),
    dict(glare=0.5, clutter=3, wood_texture=0.1, vignette=0.22),
    dict(lens_k1=0.06, rolling_shutter=(4.0, 3.0)),
    dict(hand=(640.0, 360.0, 0.8), palette="walnut", white_balance=0.05,
         motion_blur=(4.0, 1.5)),
]


@pytest.mark.parametrize("kw", SYNTH_GROUPS)
def test_synth_render_on_the_card_matches_the_cpu(kw):
    """``synth.render_frame`` at 720p on the card against the same call on
    the CPU, sensor noise off (shot noise is a draw too): corners bitwise,
    frames within a mean of 0.05 DN with at most 1e-4 of the values more
    than 2 DN apart (float rounding in blurs and remaps, a shape's rim
    pixel), one warp launch a frame."""
    from camkifu_tpu_torch.utils import synth

    dev = _device()
    labels = np.zeros((19, 19), np.int8)
    idx = np.random.default_rng(4).choice(361, 150, replace=False)
    labels.flat[idx[:75]], labels.flat[idx[75:]] = 1, 2
    before = warp_kernel.launches
    ours, corners = synth.render_frame(labels, frame_hw=(720, 1280),
                                       noise=0, seed=2, device=dev, **kw)
    assert warp_kernel.launches == before + 1
    ref, ref_corners = synth.render_frame(labels, frame_hw=(720, 1280),
                                          noise=0, seed=2, device="cpu",
                                          **kw)
    assert np.array_equal(corners, ref_corners)
    d = (ours.cpu().to(torch.int64) - ref.to(torch.int64)).abs()
    assert float(d.float().mean()) < 0.05
    assert float((d > 2).float().mean()) <= 1e-4


def test_check_and_live_latency_on_the_card():
    """``filecheck.check("synth:3")`` on the card reads every move; the
    live harness at 360×640, 8 fps, detects every move with each latency
    past 0.8 × the vote-commit floor (``tests/test_live_latency.py``'s
    gates)."""
    from camkifu_tpu_torch import filecheck
    from camkifu_tpu_torch.utils.latency import measure_live_latency

    dev = _device()
    rep = filecheck.check("synth:3", None, device=dev)
    assert rep["agreement"] == 1.0, rep
    rep = measure_live_latency(n_moves=3, fps=8.0, frame_hw=(360, 640),
                               batch=8, seed=5, timeout_s=120.0, device=dev)
    assert rep["detected"] == rep["expected"], rep
    floor = rep["floor_vote_commit_s"]
    assert all(v > floor * 0.8 for v in rep["latencies_s"]), rep

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

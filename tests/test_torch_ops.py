"""The port's tensor ops against the JAX reference on the CPU: the same
numpy inputs through both, compared at the stated tolerances. Each CUDA
kernel's plain PyTorch version is held against the reference's Pallas
kernel in interpret mode and against its XLA path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu.board import bf_auto as jbf
from camkifu_tpu.ops import color as jcolor
from camkifu_tpu.ops import edges as jedges
from camkifu_tpu.ops import filters as jfilters
from camkifu_tpu.ops import hough as jhough
from camkifu_tpu.ops import warp as jwarp
from camkifu_tpu.ops import zones as jzones
from camkifu_tpu.ops.kmeans import kmeans as jax_kmeans
from camkifu_tpu.ops.pallas.edge_kernel import BORDER, edge_magnitude
from camkifu_tpu.ops.pallas.hough_kernel import hough_accumulate_pallas
from camkifu_tpu.ops.pallas.warp_kernel import warp_to_canonical_pallas
from camkifu_tpu.utils import synth
from camkifu_tpu_torch.board import bf_auto
from camkifu_tpu_torch.board.bf_auto import resize_bilinear
from camkifu_tpu_torch.ops import color, edges, filters, hough, kmeans, warp, \
    zones
from camkifu_tpu_torch.ops.cuda import edge_kernel, hough_kernel, \
    hysteresis_kernel, warp_kernel

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _small_gray(hw=(360, 640), res=256):
    """A synthetic board frame's gray, resized to the detection res (JAX)."""
    labels = np.zeros((19, 19), np.int8)
    labels[3, 4] = 1
    labels[9, 9] = 2
    frame, _ = synth.render_frame(labels, frame_hw=hw, noise=2)
    gray = jcolor.rgb_to_gray(jcolor.to_float(jnp.asarray(frame)))
    return np.asarray(jax.image.resize(gray, (res, res), method="bilinear"))


def test_color_matches_jax():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    f32 = rng.random((17, 23, 3), dtype=np.float32)
    for x, scale in ((u8, 255.0), (f32, 1.0)):
        np.testing.assert_allclose(color.to_float(_t(x)).numpy(),
                                   np.asarray(jcolor.to_float(x)), atol=1e-5)
        # atol 1e-5 on the [0, 1] scale.
        np.testing.assert_allclose(color.rgb_to_gray(_t(x)).numpy() / scale,
                                   np.asarray(jcolor.rgb_to_gray(x)) / scale,
                                   atol=1e-5)
    assert np.array_equal(color.rgb_to_gray_u8(_t(u8)).numpy(),
                          np.asarray(jcolor.rgb_to_gray_u8(u8)))


def test_filters_match_jax():
    img = np.random.default_rng(1).random((40, 57), dtype=np.float32)
    np.testing.assert_allclose(filters.gaussian_blur(_t(img)).numpy(),
                               np.asarray(jfilters.gaussian_blur(img)),
                               atol=1e-5)
    for ours, ref in zip(filters.sobel(_t(img)), jfilters.sobel(img)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_median_u8_matches_jax():
    x = np.random.default_rng(2).random((6, 5, 49), dtype=np.float32)
    np.testing.assert_allclose(zones.median_u8(_t(x)).numpy(),
                               np.asarray(jzones.median_u8(x)), atol=1e-5)


def test_zone_stats_match_jax():
    labels = np.zeros((19, 19), np.int8)
    labels[2, 5] = 1
    labels[10, 11] = 2
    frame, corners = synth.render_frame(labels, frame_hw=(360, 640))
    canon = np.asarray(jwarp.warp_to_canonical(
        jnp.asarray(frame), jnp.asarray(corners))) / 255.0
    ours = zones.zone_stats(_t(canon.astype(np.float32)))
    ref = jzones.zone_stats(jnp.asarray(canon, jnp.float32))
    assert set(ours) == set(ref)
    assert np.array_equal(zones.corner_indices(16), jzones.corner_indices(16))
    assert np.array_equal(zones.bg_indices(19, 16), jzones.bg_indices(19, 16))
    for key in ref:
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("init", [(-0.3, 0.05, 0.3), (-0.35, 0.0, 0.35)])
def test_kmeans_matches_jax(init):
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(m, 0.05, (60, 3))
                        for m in (-0.35, 0.0, 0.35)]).astype(np.float32)
    init = np.array([[c] * 3 for c in init], np.float32)
    c_t, l_t, k_t = kmeans(_t(x), k=3, iters=8, init=_t(init))
    c_j, l_j, k_j = jax_kmeans(jnp.asarray(x), k=3, iters=8,
                               init=jnp.asarray(init))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-5)
    assert np.array_equal(l_t.numpy(), np.asarray(l_j))
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), atol=1e-5)
    # A batch of problems (the reference vmaps) solves each as alone.
    cb, lb, _ = kmeans(_t(np.stack([x, x[::-1].copy()])), k=3, iters=8,
                       init=_t(init))
    assert torch.equal(lb[0], l_t)
    torch.testing.assert_close(cb[0], c_t, atol=1e-6, rtol=0)


def test_homography_dlt_matches_jax():
    rng = np.random.default_rng(4)
    src = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    for _ in range(5):
        dst = (src + rng.uniform(-0.2, 0.2, (4, 2))).astype(np.float32)
        ours = warp.homography_dlt(_t(src), _t(dst)).numpy()
        ref = np.asarray(jwarp.homography_dlt(jnp.asarray(src),
                                              jnp.asarray(dst)))
        np.testing.assert_allclose(ours, ref, atol=1e-5)
    # Frame scale: the canonical → 1080p map, compared on the frame points.
    corners = synth.default_corners((1080, 1920), perspective=0.2)
    canon = warp.canonical_corners()
    H_t = warp.homography_dlt(canon, _t(corners))
    H_j = jwarp.homography_dlt(jwarp.canonical_corners(), jnp.asarray(corners))
    grid = np.stack(np.meshgrid(np.arange(0, 304, 37.0),
                                np.arange(0, 304, 37.0)), -1).reshape(-1, 2)
    ours = warp.apply_homography(H_t, _t(grid.astype(np.float32))).numpy()
    ref = np.asarray(jwarp.apply_homography(H_j, jnp.asarray(grid,
                                                             jnp.float32)))
    np.testing.assert_allclose(ours, ref, atol=1e-3)
    np.testing.assert_allclose(warp.apply_homography(H_t, canon).numpy(),
                               corners, atol=1e-3)


def test_degenerate_quads_score_out_like_jax():
    """A collapsed or collinear candidate quad has a singular DLT: no error,
    a non-finite homography, and evidence −1, as in the reference."""
    unit = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    quads = np.array([unit, np.full((4, 2), 5.0),
                      [[0, 0], [1, 1], [2, 2], [3, 3]]], np.float32) * 40 + 20
    H = warp.homography_dlt(_t(unit), _t(quads)).numpy()
    assert np.isfinite(H[0]).all() and not np.isfinite(H[1:]).any()
    E = np.random.default_rng(7).random((320, 320)).astype(np.float32)
    ours = bf_auto._lattice_evidence_rc(_t(E), _t(quads), 19).numpy()
    ref = np.asarray(jbf._lattice_evidence_rc(jnp.asarray(E),
                                              jnp.asarray(quads), 19))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    assert (ours[1:] == -1.0).all()
    # Warping through a non-finite homography samples NaN, no fault.
    frame = _t(np.zeros((1, 12, 16, 3), np.uint8))
    out = warp_kernel.warp_homography_ref(frame, _t(H[1]), (4, 4))
    assert out.shape == (1, 4, 4, 3) and torch.isnan(out).all()


def _edge_compare(ours, ref, border):
    inner = (slice(border, -border),) * 2
    a, b = ours[inner], ref[inner]
    both = (a > 0) & (b > 0)
    support = both.sum() / max(((a > 0) | (b > 0)).sum(), 1)
    assert support >= 0.995, support
    np.testing.assert_allclose(a[both], b[both], atol=1e-5)


def test_edge_magnitude_ref_matches_pallas_kernel():
    small = _small_gray()
    ours = edge_kernel.edge_magnitude_ref(_t(small)).numpy()
    ref = np.asarray(edge_magnitude(jnp.asarray(small), interpret=True))
    _edge_compare(ours, ref, BORDER)
    # The band the Pallas kernel zeroes follows the reference's XLA route.
    xla = np.asarray(jedges.nms_magnitude(
        *jfilters.sobel(jfilters.gaussian_blur(jnp.asarray(small)))))
    band = np.ones(ours.shape, bool)
    band[BORDER:-BORDER, BORDER:-BORDER] = False
    assert ours[band].any()
    np.testing.assert_allclose(ours[band], xla[band], atol=1e-5)
    # Batched input: each image as on its own.
    two = np.stack([small, small[::-1].copy()])
    batch = edge_kernel.edge_magnitude_ref(_t(two)).numpy()
    assert np.array_equal(batch[0], ours)


def test_edge_map_cpu_matches_jax_xla_route():
    small = _small_gray()
    ours = edges.edge_map(_t(small)).numpy()
    ref = np.asarray(jedges.edge_map(jnp.asarray(small), backend="xla"))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    assert (ours > 0).sum() > 100


def test_edge_map_batch_cpu_matches_jax_xla_route():
    """Three maps with their own thresholds through the plain route."""
    small = _small_gray()
    three = np.stack([small, small[::-1].copy(), small.T.copy() * 0.5])
    ours = edges.edge_map_batch(_t(three)).numpy()
    ref = np.asarray(jedges.edge_map_batch(jnp.asarray(three),
                                           backend="xla"))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    assert ((ours > 0).sum(axis=(1, 2)) > 100).all()
    assert edges.hysteresis is hysteresis_kernel.hysteresis_ref


def _hysteresis_maps(n=3, hw=(37, 53), seed=8):
    """Sparse seeded magnitudes: blobs of weak pixels, few strong ones, so
    that the dilation steps matter; map 0 also holds the wrap case (its only
    strong pixel in row 0, weak pixels in the last rows and columns)."""
    rng = np.random.default_rng(seed)
    mags = rng.random((n, *hw), dtype=np.float32)
    mags *= rng.random((n, *hw)) < 0.45
    mags[0] = 0.0
    mags[0, 0, 5] = 0.9
    mags[0, -3:, 3:8] = 0.5
    mags[0, 0:2, -1] = 0.5
    mags[0, 1, 0] = 0.5
    return mags


@pytest.mark.parametrize("per_frame", [False, True])
@pytest.mark.parametrize("iters", [0, 1, 4, 8])
def test_hysteresis_ref_equals_jax(iters, per_frame):
    """Exact equality with the reference, frame by frame on its side, with
    scalar thresholds and with one pair a map as (N, 1, 1) tensors."""
    mags = _hysteresis_maps()
    if per_frame:
        low = np.array([0.3, 0.2, 0.45], np.float32)
        high = np.array([0.8, 0.7, 0.95], np.float32)
        ours = hysteresis_kernel.hysteresis_ref(
            _t(mags), _t(low)[:, None, None], _t(high)[:, None, None], iters)
    else:
        low, high = np.full(3, 0.3, np.float32), np.full(3, 0.8, np.float32)
        ours = hysteresis_kernel.hysteresis_ref(_t(mags), 0.3, 0.8, iters)
    for i in range(3):
        ref = np.asarray(jedges.hysteresis(jnp.asarray(mags[i]), low[i],
                                           high[i], iters))
        assert np.array_equal(ours[i].numpy(), ref), i
    # The wrap: the weak pixels of the last rows hang on row 0's strong one.
    kept = ours[0].numpy() > 0
    assert kept[0, 5] and kept[-1, 5] == (iters >= 1)
    assert kept[-3, 5] == (iters >= 3)


def _hysteresis_banded(mag, low, high, iters, blocks, bits):
    """The kernel's design (``csrc/hysteresis.cu``) in tensor ops on one
    map: ``blocks`` bands of an even number of rows across the whole width,
    each row's weak and strong flags packed ``bits`` to a word (32 in the
    kernel); each band takes the ``iters`` rows of flags above and below it
    from the bands that hold them, rows wrapping around the map, and runs
    ``iters`` steps over the band and those rows, step t leaving out the
    t + 1 rows at either end, a word at a time from three rows, shifted
    within the word and carried across words, the column past either end
    of a row wrapping to its other end."""
    h, w = mag.shape
    band = ((-(-h // blocks)) + 1) & ~1
    kw = -(-w // bits)
    full = (1 << bits) - 1
    shifts = torch.arange(bits)

    def pack(flags):
        padded = torch.zeros((flags.shape[0], kw * bits), dtype=torch.int64)
        padded[:, :w] = flags.long()
        return (padded.view(-1, kw, bits) << shifts).sum(-1)

    def spread(x):
        last = (w - 1) % bits
        left = torch.empty_like(x)
        left[:, 1:] = x[:, :-1] >> (bits - 1)
        left[:, 0] = (x[:, (w - 1) // bits] >> last) & 1
        right = torch.empty_like(x)
        right[:, :-1] = (x[:, 1:] << (bits - 1)) & full
        right[:, -1] = (x[:, 0] & 1) << last
        return (x | ((x << 1) & full) | left | (x >> 1) | right) & full

    # Each band's own flags, as its block packs them.
    cuts = [r0 for r0 in range(0, blocks * band, band) if r0 < h]
    weak = {r0: pack(mag[r0:r0 + band] >= low) for r0 in cuts}
    strong = {r0: pack(mag[r0:r0 + band] >= high) for r0 in cuts}
    out = []
    for r0 in cuts:
        rows = weak[r0].shape[0]
        # Extended row e is map row r0 - iters + e, from the band holding
        # it.
        ys = [(r0 - iters + e) % h for e in range(rows + 2 * iters)]
        wk = torch.stack([weak[y - y % band][y % band] for y in ys])
        rc = torch.stack([strong[y - y % band][y % band] for y in ys])
        ext = rows + 2 * iters
        for t in range(iters):
            lo, hi = t + 1, ext - t - 1
            rn = rc.clone()
            rn[lo:hi] = (spread(rc[lo - 1:hi - 1]) | spread(rc[lo:hi]) |
                         spread(rc[lo + 1:hi + 1])) & wk[lo:hi]
            rc = rn
        out.append(rc[iters:iters + rows])
    bits_set = (torch.cat(out)[..., None] >> shifts) & 1
    hit = bits_set.view(h, kw * bits)[:, :w].bool()
    return torch.where(hit | (mag >= high), mag, 0.0)


@pytest.mark.parametrize("hw, tile", [
    ((37, 53), (8, 32)), ((5, 70), (8, 32)), ((33, 7), (8, 32)),
    ((37, 53), (8, 8)), ((70, 45), (16, 32)), ((1, 33), (8, 32)),
    ((2, 64), (8, 32)), ((256, 256), (8, 32))])
def test_hysteresis_tiling_equals_plain(hw, tile):
    """The kernel's bands, ``tile`` = (blocks a cluster, columns a flag
    word), each with ``iters`` rows of flags taken from the bands on either
    side, give the plain version's result: bands of 2 to 34 rows, blocks
    past the map's last row, rows beyond a band wrapping around the map
    more than once, a map of one row, partial words, and at 8-bit words a
    carry across several words a row."""
    if hw[0] > 1:
        mags = _hysteresis_maps(n=2, hw=hw, seed=9)
    else:
        rng = np.random.default_rng(9)
        mags = rng.random((2, *hw), dtype=np.float32) * 0.6
        mags[:, 0, ::7] = 0.9
    for m in mags:
        for iters in (0, 1, 4, 8):
            ref = hysteresis_kernel.hysteresis_ref(_t(m), 0.3, 0.8, iters)
            ours = _hysteresis_banded(_t(m), 0.3, 0.8, iters, *tile)
            assert torch.equal(ours, ref), (hw, iters)


def _edge_walk_emulated(x, cols, rows, seed=0):
    """The edge kernel's design (``csrc/edge.cu``) in tensor ops on one map
    ``x`` (H, W): each strip's window of 32 * ``cols`` columns and each
    segment of ``rows`` output rows, inputs clamped as they load, the
    axis-1 blur taking the window's own end columns past its ends, the
    blurred map's edge rows repeated where the walk meets them, the Sobel's
    edge columns repeated at the map's first and last column, each strip
    storing its own columns and writing the outer lines' magnitudes and
    sectors; then the outer lines' NMS, wrapped, from those alone. What a
    lane's shuffle returns past its window is random junk here, so a stored
    value that depended on it would show."""
    g = torch.Generator().manual_seed(seed)

    def junk(*shape):
        return torch.rand(shape, generator=g) * 1e3

    def sector(gx, gy):
        ax, ay = gx.abs(), gy.abs()
        t1, t2 = float(np.tan(np.pi / 8)), float(np.tan(3 * np.pi / 8))
        return torch.where(ay < t1 * ax, 0, torch.where(
            ay > t2 * ax, 2, torch.where(gx * gy >= 0, 1, 3)))

    def slot(y, n):
        """Where the scratch holds line y of n: the first of 0, n - 1, 1,
        n - 2 that it is."""
        return next((r for r, line in ((0, 0), (3, n - 1), (1, 1),
                                       (2, n - 2)) if y == line), None)

    h, w = x.shape
    taps = [float(t) for t in filters.gaussian_kernel1d(1.4)]
    rad, margin = 4, edge_kernel.MARGIN
    loaded = 32 * cols
    stored = loaded - 2 * margin
    assert edge_kernel.STRIPS[cols] == stored
    strips = edge_kernel._strips(w, cols)
    out = torch.full((h, w), float("nan"))
    rmag, cmag = torch.full((4, w), float("nan")), torch.full(
        (4, h), float("nan"))
    rsec, csec = torch.full((2, w), -1), torch.full((2, h), -1)
    for k in range(strips):
        c0 = k * stored
        xs = torch.arange(c0, c0 + loaded)
        lo = 0 if k == 0 else c0 + margin
        hi = w if k == strips - 1 else min(w, c0 + margin + stored)
        own = (xs >= lo) & (xs < hi)
        for y_lo in range(0, h, rows):
            y_hi = min(h, y_lo + rows)
            inp = x[torch.arange(y_lo - 6, y_hi + 6).clamp(0, h - 1)][
                :, xs.clamp(max=w - 1)]
            nb = y_hi - y_lo + 4               # blurred rows y_lo - 2 ..
            a0 = taps[0] * inp[:nb]
            for t in range(1, 9):
                a0 = a0 + taps[t] * inp[t:t + nb]
            e = torch.cat([a0[:, :1].expand(nb, rad), a0,
                           a0[:, -1:].expand(nb, rad)], 1)
            b = taps[0] * e[:, :loaded]
            for t in range(1, 9):
                b = b + taps[t] * e[:, t:t + loaded]
            for j in range(nb):
                yb = y_lo - 2 + j
                if yb == 0 and j > 0:
                    b[j - 1] = b[j]
                elif yb == h:
                    b[j] = b[j - 1]
            nm = nb - 2                        # magnitude rows y_lo - 1 ..
            sm = (b[:nm] + 2.0 * b[1:nm + 1]) + b[2:]
            d = b[2:] - b[:nm]
            smp = torch.cat([sm[:, :1], sm, junk(nm, 1)], 1)
            dp = torch.cat([d[:, :1], d, junk(nm, 1)], 1)
            if w - 1 - c0 < loaded:
                smp[:, w - c0 + 1] = smp[:, w - c0]
                dp[:, w - c0 + 1] = dp[:, w - c0]
            gx = smp[:, 2:] - smp[:, :-2]
            gy = (dp[:, :-2] + 2.0 * dp[:, 1:-1]) + dp[:, 2:]
            mag = torch.sqrt(gx * gx + gy * gy)
            sec = sector(gx, gy)
            mp = torch.cat([junk(nm, 1), mag, junk(nm, 1)], 1)
            for yo in range(y_lo, y_hi):
                r = yo - y_lo + 1
                n1 = torch.stack([mp[r, :-2], mp[r - 1, :-2], mp[r - 1, 1:-1],
                                  mp[r - 1, 2:]])
                n2 = torch.stack([mp[r, 2:], mp[r + 1, 2:], mp[r + 1, 1:-1],
                                  mp[r + 1, :-2]])
                s = sec[r][None]
                m = mag[r]
                keep = (m >= n1.gather(0, s)[0]) & (m >= n2.gather(0, s)[0])
                out[yo, xs[own]] = torch.where(keep, m, 0.0)[own]
                rs = slot(yo, h)
                if rs is not None:
                    rmag[rs, xs[own]] = m[own]
                    if rs in (0, 3):
                        rsec[rs // 3, xs[own]] = sec[r][own]
                for xx in xs[own].tolist():
                    cs = slot(xx, w)
                    if cs is not None:
                        cmag[cs, yo] = m[xx - c0]
                        if cs in (0, 3):
                            csec[cs // 3, yo] = sec[r][xx - c0]

    def at(y, x):
        rs = slot(y, h)
        return rmag[rs, x] if rs is not None else cmag[slot(x, w), y]

    def sec_at(y, x):
        rs = slot(y, h)
        if rs in (0, 3):
            return int(rsec[rs // 3, x])
        return int(csec[slot(x, w) // 3, y])

    outer = [(y, x) for y in range(h) for x in range(w)
             if y in (0, h - 1) or x in (0, w - 1)]
    for y, x in outer:
        sc = sec_at(y, x)
        yn, ys = (y - 1) % h, (y + 1) % h
        xw, xe = (x - 1) % w, (x + 1) % w
        x1 = xw if sc <= 1 else (x if sc == 2 else xe)
        x2 = xe if sc <= 1 else (x if sc == 2 else xw)
        m = at(y, x)
        n1 = at(y if sc == 0 else yn, x1)
        n2 = at(y if sc == 0 else ys, x2)
        out[y, x] = m if m >= n1 and m >= n2 else 0.0
    return out


@pytest.mark.parametrize("hw", [(1, 64), (64, 1), (3, 3), (1, 1), (2, 5),
                                (15, 64), (64, 12), (16, 16), (17, 300),
                                (23, 129), (9, 257), (40, 37), (5, 126),
                                (4, 256), (6, 238)])
@pytest.mark.parametrize("cols", [4, 8])
def test_edge_boundary_scheme_equals_plain(hw, cols):
    """The edge kernel's boundary scheme (per-stage clamping in the walks,
    the outer lines' NMS from the walks' scratch) is ``torch.equal`` to
    ``edge_magnitude_ref`` at 1 to H rows a segment: odd sizes, maps under
    2 * MARGIN a side, one row or one column, widths of one to three
    strips, and maps whose last column lies within the blur's radius of
    the last window's end."""
    gen = torch.Generator().manual_seed(hw[0] * 1000 + hw[1] + cols)
    x = torch.rand(hw, generator=gen)
    x = 0.8 * (torch.linspace(0, 1, hw[1]) > 0.3).float() + 0.2 * x
    if hw[0] > 4:
        x[hw[0] // 2:] = torch.rand((hw[0] - hw[0] // 2, hw[1]),
                                    generator=gen)
    ref = edge_kernel.edge_magnitude_ref(x)
    assert float(ref.max()) > 0.0 or hw == (1, 1)
    for rows in sorted({1, 4, 13, hw[0]}):
        ours = _edge_walk_emulated(x, cols, rows)
        assert torch.equal(ours, ref), (rows, int((ours != ref).sum()))


def _hough_points():
    rng = np.random.default_rng(0)
    img = np.zeros((128, 128), np.float32)
    img[40, :] = 1.0
    img[:, 100] = 1.0
    img += rng.random((128, 128)).astype(np.float32) * 0.05
    return img


def test_hough_accumulate_ref_matches_jax():
    img = _hough_points()
    pts_j, wts_j = jhough.topk_edge_points(jnp.asarray(img), k=1024)
    pts_t, wts_t = hough.topk_edge_points(_t(img), k=1024)
    assert np.array_equal(pts_t.numpy(), np.asarray(pts_j))
    np.testing.assert_allclose(wts_t.numpy(), np.asarray(wts_j), atol=1e-6)
    rho_max = float(np.hypot(128, 128))
    ours = hough_kernel.hough_accumulate_ref(pts_t, wts_t, rho_max, 64, 256)
    xla = np.asarray(jhough.hough_accumulate(pts_j, wts_j, rho_max, 64, 256))
    pallas = np.asarray(hough_accumulate_pallas(pts_j, wts_j, rho_max, 64,
                                                256, interpret=True))
    np.testing.assert_allclose(ours.numpy(), xla, atol=1e-2)
    np.testing.assert_allclose(ours.numpy(), pallas, atol=1e-2)
    # The dispatcher takes the plain version for a CPU tensor.
    assert torch.equal(hough.hough_accumulate(pts_t, wts_t, rho_max, 64, 256),
                       ours)


def test_hough_accumulate_ref_nonmultiple_k():
    pts = np.array([[10.0, 20.0], [30.0, 7.0]], np.float32)
    wts = np.array([1.0, 2.0], np.float32)
    ours = hough_kernel.hough_accumulate_ref(_t(pts), _t(wts), 64.0, 16, 128)
    ref = jhough.hough_accumulate(jnp.asarray(pts), jnp.asarray(wts), 64.0,
                                  16, 128)
    pallas = hough_accumulate_pallas(jnp.asarray(pts), jnp.asarray(wts),
                                     64.0, 16, 128, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), atol=1e-4)


def test_warp_to_canonical_ref_matches_jax_and_pallas():
    labels = np.zeros((19, 19), np.int8)
    labels[3, 3] = 1
    labels[15, 15] = 2
    frame, corners = synth.render_frame(labels, frame_hw=(720, 1280))
    ours = warp_kernel.warp_to_canonical_ref(_t(frame), _t(corners)).numpy()
    ref = np.asarray(jwarp.warp_to_canonical(jnp.asarray(frame),
                                             jnp.asarray(corners)))
    assert np.abs(ours - ref).max() / 255.0 <= 1e-3
    pallas = np.asarray(warp_to_canonical_pallas(
        jnp.asarray(frame), jnp.asarray(corners), interpret=True))
    assert np.abs(ours - pallas).max() < 0.05
    # The module-level path (dispatch on a CPU tensor, batch, fused scale).
    batch = warp.warp_batch_fixed(_t(np.stack([frame, frame])), _t(corners),
                                  scale=1.0 / 255.0).numpy()
    np.testing.assert_allclose(batch[1], ours / 255.0, atol=1e-6)
    one = warp.warp_to_canonical(_t(frame), _t(corners)).numpy()
    assert np.array_equal(one, ours)


@pytest.mark.parametrize("hw", [(360, 640), (720, 1280)])
def test_resize_matches_jax_image_resize(hw):
    img = np.random.default_rng(5).random(hw, dtype=np.float32)
    ours = resize_bilinear(_t(img), (256, 256)).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (256, 256),
                                      method="bilinear"))
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_top_k_keeps_lax_tie_order():
    """Integer-valued projections tie massively (the coarse quad's corner
    search): the port must pick the same indices as lax.top_k."""
    res = 64
    ys, xs = np.mgrid[0:res, 0:res].astype(np.float32)
    mask = np.random.default_rng(6).random((res, res)) > 0.3
    for proj in (-(xs + ys), xs - ys, xs + ys, ys - xs):
        p = np.where(mask, proj, -np.inf).reshape(-1).astype(np.float32)
        _, idx_j = jax.lax.top_k(jnp.asarray(p), 49)
        _, idx_t = hough.top_k(_t(p), 49)
        assert np.array_equal(idx_t.numpy(), np.asarray(idx_j))


@pytest.mark.parametrize("call", ["warp", "edge", "hough", "hysteresis"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A kernel wrapper launches on CUDA tensors or raises; it never falls
    back to its plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        if call == "warp":
            frames = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
            warp_kernel.warp_homography(frames, torch.eye(3), (4, 4))
        elif call == "edge":
            edge_kernel.edge_magnitude(torch.zeros((32, 32)))
        elif call == "hysteresis":
            hysteresis_kernel.hysteresis(torch.zeros((32, 32)), 0.1, 0.2)
        else:
            hough_kernel.hough_accumulate(torch.zeros((4, 2)), torch.ones(4),
                                          10.0, 8, 16)

"""The hysteresis kernel's percentile select on the CPU: the kernel's
design (``csrc/hysteresis.cu``) in tensor ops against ``torch.quantile``,
and the plain version of ``hysteresis_adaptive`` against the reference's
own threshold tail (``camkifu_tpu/ops/edges.py:104-105``, ``:133-136``).
The kernel itself is held to its plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu.ops import edges as jedges
from camkifu_tpu_torch.ops import edges
from camkifu_tpu_torch.ops.cuda import hysteresis_kernel

torch.set_num_threads(1)

MASK32 = 0xffffffff


def _order_keys(x):
    """float32 → the kernel's order-preserving 32-bit keys (as int64)."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & MASK32
    return torch.where(b >= 1 << 31, b ^ MASK32, b | (1 << 31))


def _key_value(k: int) -> torch.Tensor:
    b = k & 0x7fffffff if k >= 1 << 31 else k ^ MASK32
    return torch.tensor([b - (1 << 32) if b >= 1 << 31 else b],
                        dtype=torch.int32).view(torch.float32)[0]


def _fma32(a, b, c):
    """float32 ``a * b + c`` rounded once: the product is exact in float64,
    the float64 sum is rounded to odd (TwoSum's error moves an even result
    one step toward the exact sum), and rounding that to float32 is then
    exact (53 bits ≥ 24 + 2)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even, torch.nextafter(s, s + err), s)
    return s.float()


def _lerp_aten(s, e, w):
    """ATen's lerp, both branches, each product fused into its sum (the
    form the kernel takes; ``torch.lerp`` on this CPU is the same)."""
    d = e - s
    return torch.where(w.abs() < 0.5, _fma32(w, d, s),
                       _fma32(-d, 1.0 - w, e))


CAP = 256      # keys the kernel gathers to finish a select in each block


def _select_emulated(mags, q=99.5, blocks=hysteresis_kernel.CLUSTER,
                     paths=None):
    """Each map's ``q``-th percentile of its 2×-strided view as the
    kernel's cluster selects it: ``blocks`` bands of an even number of
    rows, each band's keys of its even rows and columns counted into
    256-bin histograms, summed over the bands, rounds of 8 bits for both
    order statistics ``floor(rank)`` and ``ceil(rank)``. After two rounds,
    if the keys under the two 16-bit prefixes number at most ``CAP``, the
    bands' lists of them (in band order) finish the select with two rounds
    over the list alone; else two more rounds over all keys. Any NaN in the
    view gives NaN. ``paths`` collects "list" or "rounds" a map."""
    n, h, w = mags.shape
    band = ((-(-h // blocks)) + 1) & ~1
    kcols = (w + 1) // 2
    nv = ((h + 1) // 2) * kcols
    rank = torch.tensor(q / 100.0, dtype=torch.float32) * \
        torch.tensor(float(nv - 1), dtype=torch.float32)
    lo = int(rank)
    targets = (lo, int(torch.ceil(rank)))
    weight = rank - torch.tensor(float(lo), dtype=torch.float32)

    def radix(keys, pref, below, target, shift):
        """One round: the bin of ``target`` among ``keys`` under ``pref``
        (the keys' histograms summed as given), and the count below it."""
        mask = (MASK32 << (shift + 8)) & MASK32 if shift < 24 else 0
        count = sum(torch.bincount((k[(k & mask) == pref] >> shift) & 0xff,
                                   minlength=256) for k in keys)
        start = below + torch.cumsum(count, 0) - count
        inside = (start <= target) & (target < start + count)
        b = int(inside.nonzero()[0, 0])
        return pref | b << shift, int(start[b]), int(count[b])

    out = []
    for m in mags:
        views = [m[r0:r0 + band][::2, ::2].reshape(-1)
                 for r0 in range(0, blocks * band, band)]
        keys = [_order_keys(v) for v in views]
        pref, below, cnt = [0, 0], [0, 0], [0, 0]
        for shift in (24, 16):
            for t in (0, 1):
                pref[t], below[t], cnt[t] = radix(keys, pref[t], below[t],
                                                  targets[t], shift)
        total = cnt[0] + (cnt[1] if pref[0] != pref[1] else 0)
        if total <= CAP:
            lists = [torch.cat([k[(k & 0xffff0000) == pref[t]]
                                for k in keys]) for t in (0, 1)]
            for shift in (8, 0):
                for t in (0, 1):
                    pref[t], below[t], _ = radix(
                        [lists[t]], pref[t], below[t], targets[t], shift)
        else:
            for shift in (8, 0):
                for t in (0, 1):
                    pref[t], below[t], _ = radix(keys, pref[t], below[t],
                                                 targets[t], shift)
        if paths is not None:
            paths.append("list" if total <= CAP else "rounds")
        if any(bool(torch.isnan(v).any()) for v in views):
            out.append(torch.tensor(float("nan")))
        else:
            out.append(_lerp_aten(_key_value(pref[0]), _key_value(pref[1]),
                                  weight))
    return torch.stack(out)


def _maps(shape, seed, kind="sparse"):
    rng = np.random.default_rng(seed)
    if kind == "sparse":     # NMS-like: mostly zeros, a tail of edges
        m = rng.random(shape, dtype=np.float32) ** 3
        return m * (rng.random(shape) < 0.2)
    if kind == "signed":     # negative values, -0.0 beside +0.0
        m = rng.standard_normal(shape).astype(np.float32)
        m[..., ::5, ::3] = -0.0
        m[..., 1::5, ::3] = 0.0
        return m
    if kind == "zero":
        return np.zeros(shape, np.float32)
    if kind == "ties":       # constant maps, and few distinct values
        m = np.full(shape, 0.25, np.float32)
        m[1:] = rng.integers(0, 3, m[1:].shape).astype(np.float32) / 4
        return m
    raise ValueError(kind)


def _same(ours, ref):
    torch.testing.assert_close(ours, ref, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("shape, kind", [
    ((2, 256, 256), "sparse"), ((2, 512, 512), "sparse"),
    ((3, 37, 53), "sparse"), ((2, 255, 257), "sparse"),
    ((3, 5, 3), "sparse"), ((2, 37, 53), "signed"), ((2, 64, 64), "zero"),
    ((3, 40, 30), "ties"), ((2, 1, 1), "sparse"), ((2, 20, 20), "sparse")])
def test_select_emulated_equals_quantile(shape, kind):
    """The kernel's select, emulated, is ``percentile`` bitwise (NaN where
    it is NaN): at the paths' 256² and 512², odd shapes, one pixel, all
    zeros, ties, negative values and signed zeros, finishing from the
    gathered lists and (where ties fill them) over all keys; 20 × 20 (a
    view of 100) puts the rank's weight at 0.505, in ``lerp``'s second
    branch."""
    mags = torch.from_numpy(_maps(shape, seed=sum(shape), kind=kind))
    n = shape[0]
    ref = edges.percentile(mags[:, ::2, ::2].reshape(n, -1), 99.5, dim=1)
    paths = []
    _same(_select_emulated(mags, paths=paths), ref)
    if kind in ("zero", "ties"):
        assert "rounds" in paths      # the ties fill the lists
    if shape == (2, 256, 256):
        assert paths == ["list", "list"]
    if shape[1:] == (20, 20):
        rank = torch.tensor(0.995, dtype=torch.float32) * 99.0
        assert float(rank - rank.floor()) >= 0.5


@pytest.mark.parametrize("q", [0.0, 50.0, 90.0, 100.0])
def test_select_emulated_equals_quantile_at_other_q(q):
    """Every rank, not only the paths' 99.5th: both ends and the median."""
    mags = torch.from_numpy(_maps((3, 45, 61), seed=int(q), kind="signed"))
    ref = edges.percentile(mags[:, ::2, ::2].reshape(3, -1), q, dim=1)
    _same(_select_emulated(mags, q), ref)


def test_select_emulated_nan_gives_nan():
    """A NaN in the strided view makes that map's percentile NaN (and every
    threshold comparison false); a NaN off the view changes nothing."""
    mags = torch.from_numpy(_maps((3, 64, 64), seed=4))
    mags[0, 10, 20] = float("nan")       # in the view
    mags[1, 11, 21] = float("nan")       # an odd row and column
    ref = edges.percentile(mags[:, ::2, ::2].reshape(3, -1), 99.5, dim=1)
    ours = _select_emulated(mags)
    _same(ours, ref)
    assert torch.isnan(ours).tolist() == [True, False, False]
    out = hysteresis_kernel.hysteresis_adaptive_ref(mags, 0.15, 0.4, 4)
    assert float(out[0].abs().max()) == 0.0 and bool((out[1] > 0).any())


def test_lerp_emulated_equals_torch_lerp():
    """The select's lerp (fused products, both branches) is ``torch.lerp``
    on this CPU over 10⁵ triples, weights in [0, 1) and at 0.5."""
    rng = np.random.default_rng(3)
    s, e = (torch.from_numpy(rng.standard_normal(100_000).astype(np.float32))
            for _ in range(2))
    w = torch.from_numpy(rng.random(100_000, dtype=np.float32))
    w[::97] = 0.5
    assert torch.equal(_lerp_aten(s, e, w), torch.lerp(s, e, w))


@pytest.mark.parametrize("iters", [0, 1, 4, 8])
def test_hysteresis_adaptive_ref_equals_jax_tail(iters):
    """``hysteresis_adaptive_ref`` against the reference's threshold tail
    on the same magnitudes: the percentile within 1 ulp (``jnp.percentile``
    interpolates as ``lo · (1 − w) + hi · w``, ``torch.quantile`` by
    ``lerp``) and, as ``test_hysteresis_ref_equals_jax`` holds the
    hysteresis, the output maps exactly equal."""
    mags = _maps((3, 64, 96), seed=12)
    ours = hysteresis_kernel.hysteresis_adaptive_ref(
        torch.from_numpy(mags), 0.15, 0.4, iters)
    ref_t = edges.percentile(torch.from_numpy(mags[:, ::2, ::2]).reshape(
        3, -1), 99.5, dim=1)
    jm = jnp.asarray(mags)
    ref_j = jnp.percentile(jm[:, ::2, ::2], 99.5, axis=(1, 2))
    np.testing.assert_array_max_ulp(ref_t.numpy(), np.asarray(ref_j), 1)
    out = jax.vmap(lambda m, r: jedges.hysteresis(
        m, 0.15 * r, 0.4 * r, iters))(jm, ref_j)
    assert np.array_equal(ours.numpy(), np.asarray(out))
    assert int((ours > 0).sum()) > 0

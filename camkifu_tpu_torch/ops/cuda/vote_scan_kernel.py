"""The temporal vote scan of ``stone.sf_meta.scan_streams`` in one launch.

Replaces no Pallas kernel: the reference's scan is the ``jax.lax.scan`` in
``camkifu_tpu/stone/sf_meta.py`` ``_scan_canonical``, which XLA compiles
into one loop. Eager PyTorch runs its body as some 52 small launches a
frame (``vote_scan_ref``), each a few µs of work behind a launch that costs
the host far more, with the card idle in between. The CUDA source
``camkifu_tpu_torch/csrc/vote_scan.cu`` runs every stream's carry over
every frame in one launch: a block a stream for the votes, a thread an
intersection holding its votes and stable label in registers, and blocks
of a thread a background pixel; what bounds it is the latency of the
serial recurrence, not its ~4.5 MB of traffic.

Contract (both versions): ``labs`` (lab_cont, lab_clus, lab_nn), each (n,
B, g, g) int8; ``confs`` (conf_cont, conf_clus, conf_nn), each (n, B, g, g)
float32 (a voter's confidence of -1 never wins against a contour reading);
``zone_calm`` (n, B, g, g) float32; ``agitation`` (n, B) float32;
``region_agree`` (n, B, 3, 3) float32; ``luma_small`` (n, B, h, w)
float32; ``carry`` (votes (n, g, g, 3) float32, stable (n, g, g) int8, bg
(n, h, w) float32, trust (n, 3, 3) float32); ``valid_count`` a Python int:
frames at index >= it emit the stable board and the carried votes'
confidence and leave the carry as it is. Returns (labels (n, B, g, g) int8,
the stable board after each frame; conf (n, B, g, g) float32; the new
carry), every output a new tensor: the inputs are never written. On the
card the kernel is bitwise the plain version run there (the card's plain
version divides by the vote window as a multiply by its float32
reciprocal; the CPU's divides). NaN inputs follow the plain version: an
agitation of NaN neither gates the trust nor slows the background, a NaN
confidence wins the pick as ``torch.argmax`` picks it and casts no vote, a
NaN vote makes its intersection's top NaN (no commit, confidence NaN) and
its argmax that label, a NaN background pixel (0, 0) does not read as
uninitialised. The kernel takes boards up to 19 × 19 (a thread an
intersection of a block); it raises beyond.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from camkifu_tpu_torch.config import cvconf
from camkifu_tpu_torch.ops import background
from camkifu_tpu_torch.ops.cuda import _build
from camkifu_tpu_torch.stone.votes import vote_update

#: Region-trust EMA rate and the threshold above which a region switches
#: from contours to clustering (the reference's calibration→search promote).
TRUST_EMA = 0.08
TRUST_PROMOTE = 0.9

#: Kernel launches since the last reset (one per call on CUDA tensors).
launches = 0


def region_index(gsize: int) -> np.ndarray:
    """(g, g) int: which of the 3×3 sub-boards each intersection belongs to
    (``region_of`` in the CUDA source)."""
    thirds = np.minimum(np.arange(gsize) * 3 // gsize, 2)
    return (thirds[:, None] * 3 + thirds[None, :]).astype(np.int32)


@functools.lru_cache(maxsize=8)
def regions(gsize: int, device):
    """(flat region index (g·g,) int64, intersections per region (9,))."""
    region = region_index(gsize).reshape(-1)
    counts = np.bincount(region, minlength=9).astype(np.float32)
    return (torch.as_tensor(region, dtype=torch.int64, device=device),
            torch.as_tensor(counts, device=device))


@functools.cache
def _consts():
    """The scan's constants as the plain version's float32 arithmetic takes
    the Python scalars, in the order of ``Consts`` in the CUDA source."""
    f32 = np.float32
    cfg = cvconf.DEFAULT
    ema = cfg.background_ema
    values = (cfg.agitation_threshold, 1 - TRUST_EMA, TRUST_EMA,
              TRUST_PROMOTE, 1.0 - 1.0 / cfg.vote_window, cfg.vote_min_conf,
              cfg.vote_threshold, f32(1) / f32(cfg.vote_window), ema,
              0.1 * ema)
    return (ctypes.c_float * len(values))(*(float(f32(v)) for v in values))


def _check(labs, confs, zone_calm, agitation, region_agree, luma_small,
           carry) -> None:
    """Dtypes, shapes and one device, as the contract states."""
    votes, stable, bg, trust = carry
    if len(labs) != 3 or len(confs) != 3:
        raise ValueError("vote_scan takes three label and three confidence "
                         "tensors")
    if labs[0].ndim != 4 or bg.ndim != 3:
        raise ValueError(f"vote_scan takes (n, B, g, g) labels and an (n, h, "
                         f"w) background, got {tuple(labs[0].shape)} and "
                         f"{tuple(bg.shape)}")
    n, b, g = labs[0].shape[:3]
    hw = tuple(bg.shape[1:])
    want = [(x, torch.int8, (n, b, g, g)) for x in labs] + \
        [(x, torch.float32, (n, b, g, g)) for x in confs] + [
        (zone_calm, torch.float32, (n, b, g, g)),
        (agitation, torch.float32, (n, b)),
        (region_agree, torch.float32, (n, b, 3, 3)),
        (luma_small, torch.float32, (n, b) + hw),
        (votes, torch.float32, (n, g, g, 3)),
        (stable, torch.int8, (n, g, g)),
        (bg, torch.float32, (n,) + hw),
        (trust, torch.float32, (n, 3, 3))]
    for x, dtype, shape in want:
        if x.dtype != dtype:
            raise TypeError(f"vote_scan takes {dtype} for its "
                            f"{tuple(shape)} input, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"vote_scan expected shape {tuple(shape)}, got "
                             f"{tuple(x.shape)}")
        if x.device != votes.device:
            raise ValueError(f"vote_scan's inputs lie on one device, got "
                             f"{x.device} and {votes.device}")


def vote_scan(labs, confs, zone_calm: torch.Tensor, agitation: torch.Tensor,
              region_agree: torch.Tensor, luma_small: torch.Tensor, carry,
              valid_count: int):
    """The scan: the kernel on CUDA tensors (one launch, no host wait),
    ``vote_scan_ref`` on CPU tensors. CUDA inputs must be contiguous."""
    global launches
    _check(labs, confs, zone_calm, agitation, region_agree, luma_small, carry)
    inputs = (*labs, *confs, zone_calm, agitation, region_agree, luma_small,
              *carry)
    dev = carry[0].device
    if dev.type == "cpu":
        return vote_scan_ref(labs, confs, zone_calm, agitation, region_agree,
                             luma_small, carry, valid_count)
    if dev.type != "cuda":
        raise ValueError(f"vote_scan runs on CUDA or CPU tensors, got {dev}")
    if not all(x.is_contiguous() for x in inputs):
        raise ValueError("vote_scan needs contiguous CUDA tensors")
    lib = _build.lib()
    n, b, g = labs[0].shape[:3]
    if g * g > lib.camkifu_vote_scan_threads():
        raise ValueError(f"the vote scan kernel takes boards of at most "
                         f"{lib.camkifu_vote_scan_threads()} intersections, "
                         f"got {g} × {g}")
    votes, stable, bg, trust = carry
    outs = (torch.empty((n, b, g, g), dtype=torch.int8, device=dev),
            torch.empty((n, b, g, g), dtype=torch.float32, device=dev),
            torch.empty_like(votes), torch.empty_like(stable),
            torch.empty_like(bg), torch.empty_like(trust))
    ptrs = (ctypes.c_void_p * 20)(*(x.data_ptr() for x in inputs + outs))
    npix = bg.shape[1] * bg.shape[2]
    with torch.cuda.device(dev):
        code = lib.camkifu_vote_scan(
            ptrs, _consts(), n, b, g, npix,
            min(max(int(valid_count), 0), b), _build.stream_handle(dev))
    _build.check(code, "vote scan")
    launches += 1
    return outs[0], outs[1], outs[2:]


def vote_scan_ref(labs, confs, zone_calm: torch.Tensor,
                  agitation: torch.Tensor, region_agree: torch.Tensor,
                  luma_small: torch.Tensor, carry, valid_count: int):
    """Plain PyTorch version, on any device: a loop over frames whose every
    branch is a ``torch.where``, so it never waits for the device."""
    lab_cont, lab_clus, lab_nn = labs
    conf_cont, conf_clus, conf_nn = confs
    votes, stable, bg, trust = carry
    n, b, gsize = lab_cont.shape[:3]
    dev = lab_cont.device
    cfg = cvconf.DEFAULT
    region, _ = regions(gsize, dev)
    valid = torch.arange(b, device=dev) < valid_count
    out_labels, out_conf = [], []
    for i in range(b):
        calm = (agitation[:, i] <= cfg.agitation_threshold)[:, None, None]
        new_trust = torch.where(
            calm, trust * (1 - TRUST_EMA) + region_agree[:, i] * TRUST_EMA,
            trust)
        trust_per = new_trust.reshape(n, 9)[:, region] \
            .reshape(n, gsize, gsize)
        # Eligible readings compete by confidence: contours always,
        # clustering once its region's trust promotes, the net when given.
        ck_eff = torch.where(trust_per >= TRUST_PROMOTE, conf_clus[:, i],
                             -1.0)
        confs = torch.stack([conf_cont[:, i], ck_eff, conf_nn[:, i]])
        labs = torch.stack([lab_cont[:, i], lab_clus[:, i], lab_nn[:, i]])
        pick = torch.argmax(confs, dim=0, keepdim=True)      # (1, n, g, g)
        labels = torch.gather(labs, 0, pick)[0]
        conf = torch.gather(confs, 0, pick)[0]
        new_votes, new_stable, new_conf = vote_update(
            votes, stable, labels, conf, zone_calm[:, i], cfg)
        new_bg = background.update_background(
            torch.where(bg[:, :1, :1] < 0, luma_small[:, i], bg),
            luma_small[:, i], agitation[:, i], cfg.background_ema)
        # Padded frames emit the current stable reading but leave the carry
        # untouched.
        old_conf = torch.clamp(votes.amax(dim=-1) / cfg.vote_window, 0.0,
                               1.0)
        v = valid[i]
        votes = torch.where(v, new_votes, votes)
        stable = torch.where(v, new_stable, stable)
        bg = torch.where(v, new_bg, bg)
        trust = torch.where(v, new_trust, trust)
        out_labels.append(stable)
        out_conf.append(torch.where(v, new_conf, old_conf))
    return torch.stack(out_labels, 1), torch.stack(out_conf, 1), \
        (votes, stable, bg, trust)

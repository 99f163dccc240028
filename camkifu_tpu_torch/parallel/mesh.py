"""Several independent board streams on one card (BASELINE config 5): port
of camkifu_tpu/parallel/mesh.py, which shards the streams over a device
mesh. The module keeps the reference's name so each counterpart is easy
to find, but the port runs on one card and has no mesh: the streams are
flattened into the batch, or carried as a leading tensor dimension where
each stream has state, so n streams cost the device operations of one.
The reference's ``stream_sharding``, ``_read_fn`` and ``_track_fn`` are
mesh and jit plumbing and have no counterpart; its ``lax.map`` over
streams, a workaround for the TPU's batched-gather cliff, is not copied.

Inputs: frames (n, B, H, W, 3) uint8 (or float in [0, 1] on the CPU),
corners or seeds (n, 4, 2), one set per stream. The device follows the
tensors.
"""

from __future__ import annotations

import torch

from camkifu_tpu_torch.board.bf_auto import rectify_track_streams
from camkifu_tpu_torch.config import cvconf, guiconf
from camkifu_tpu_torch.ops.lens import Lens
from camkifu_tpu_torch.ops.warp import canonical_corners, homography_dlt, \
    warp_frames
from camkifu_tpu_torch.stone import sf_clustering, sf_meta


def _warp_streams(frames: torch.Tensor, corners: torch.Tensor, gsize: int,
                  zone: int) -> torch.Tensor:
    """Every stream's frames (n, B, H, W, C) to the canonical image
    through its own fixed corners (n, 4, 2) → (n·B, S, S, C) in [0, 1] for
    uint8: one warp launch for all n·B frames, each stream's homography
    repeated over its B frames."""
    n, b = frames.shape[0], frames.shape[1]
    size = gsize * zone
    scale = 1.0 / 255.0 if frames.dtype == torch.uint8 else 1.0
    H = homography_dlt(canonical_corners(gsize, zone, corners.device),
                       corners.to(torch.float32))               # (n, 3, 3)
    hmats = H[:, None].expand(n, b, 3, 3).reshape(n * b, 3, 3)
    return warp_frames(frames.reshape(n * b, *frames.shape[2:]), hmats,
                       (size, size), scale)


def _read_all_streams(frames: torch.Tensor, corners: torch.Tensor,
                      gsize: int = guiconf.gsize,
                      zone: int = cvconf.zone_size):
    """The c5 path (the reference's ``_read_all_streams`` and the
    ``_read_streams_local`` body it runs): classify the frames of n
    fixed-camera streams → (labels (n, B, g, g) int8, confidence
    (n, B, g, g)). One warp launch, then the classifier on the flat n·B
    batch."""
    n, b = frames.shape[0], frames.shape[1]
    labels, conf = sf_clustering.classify_canonical(
        _warp_streams(frames, corners, gsize, zone), gsize, zone)
    return labels.reshape(n, b, gsize, gsize), conf.reshape(n, b, gsize,
                                                            gsize)


def multistream_read(frames: torch.Tensor, corners: torch.Tensor,
                     gsize: int = guiconf.gsize,
                     zone: int = cvconf.zone_size):
    """Classify the frames of n independent streams, each with its own
    fixed corners: ``_read_all_streams``. The reference's ``mesh``
    argument is dropped (one card; the device follows the tensors).
    Returns (labels (n, B, g, g), confidence (n, B, g, g))."""
    return _read_all_streams(frames, corners, gsize, zone)


def multistream_init_states(n_streams: int, gsize: int = guiconf.gsize,
                            zone: int = cvconf.zone_size,
                            device="cuda") -> sf_meta.MetaState:
    """Fresh vote-scan states of n streams on ``device`` (the card unless
    the caller asks for the CPU): every field of ``sf_meta.init_state``
    with a leading stream axis, ``frame_count`` (n,)."""
    one = sf_meta.init_state(gsize, zone, device)
    return sf_meta.MetaState(*(
        x[None].expand(n_streams, *x.shape).clone() for x in one))


def multistream_read_meta(states: sf_meta.MetaState, frames: torch.Tensor,
                          corners: torch.Tensor, gsize: int = guiconf.gsize,
                          zone: int = cvconf.zone_size):
    """Config 5 with temporal tracking (the reference's
    ``_meta_all_streams`` under a mesh): ``sf_meta.read_batch`` of n
    fixed-camera streams at once, each with its own vote and background
    state (``multistream_init_states``) and its own corners. One warp
    launch, then the stream-batched vote scan. Returns (states, labels
    (n, B, g, g), conf (n, B, g, g), agitation (n, B))."""
    n, b = frames.shape[0], frames.shape[1]
    canon = _warp_streams(frames, corners, gsize, zone)
    return sf_meta.scan_streams(states,
                                canon.reshape(n, b, *canon.shape[1:]),
                                gsize, zone)


def multistream_track_read(states: sf_meta.MetaState, frames: torch.Tensor,
                           seeds: torch.Tensor, gsize: int = guiconf.gsize,
                           zone: int = cvconf.zone_size,
                           lenses: Lens | None = None):
    """Config 4 × config 5 (the reference's ``_track_all_streams`` under a
    mesh): the fused tracking engine (per-frame board tracking,
    rectification, classification, vote scan) over n independent handheld
    streams, the stream-batched tracker (one warp launch a chunk for every
    stream) then the stream-batched vote scan. Each stream's seed (its
    last detection or previous ``new_seed``) re-anchors at its own last
    frame. Nothing in the call waits for the device. ``lenses``: None, or
    each stream's camera as one stacked ``ops.lens.Lens``
    (``stack_lenses``, made once and held across calls; independent
    streams come from different cameras), or one ``Lens`` for all.

    Returns (states, labels (n, B, g, g), conf, agitation (n, B), corners
    (n, B, 4, 2), sharpness (n, B), align (n, B), new_seeds (n, 4, 2)).
    """
    canon, corners, sharp, align, new_seeds = rectify_track_streams(
        frames, seeds, gsize=gsize, zone=zone, lenses=lenses)
    new_states, labels, conf, agitation = sf_meta.scan_streams(
        states, canon, gsize, zone)
    return (new_states, labels, conf, agitation, corners, sharp, align,
            new_seeds)

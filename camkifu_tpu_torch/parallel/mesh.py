"""Several independent board streams (BASELINE config 5) on one card or
sharded over several: port of camkifu_tpu/parallel/mesh.py.

On one device the streams are flattened into the batch, or carried as a
leading tensor dimension where each stream has state, so n streams cost
the device operations of one. The reference's ``lax.map`` over streams, a
workaround for the TPU's batched-gather cliff, is not copied.

Over several devices (the reference's 1-D "stream" mesh and its
``P("stream")`` sharding): ``make_mesh`` is an ordered tuple of
``torch.device``s, ``stream_sharding`` cuts the streams into contiguous
slices, one a mesh entry, and every entry point takes ``mesh=``. Each
shard's frames, seeds, lenses and states are copied to its device
(``shard``), then every shard's one-device body is launched, each under
its own device, before anything is read; no tensor crosses devices after
that upload, as the reference's shard_map holds zero collectives. States
stay on their shard's device across calls. Results come back as
``Sharded``: a tuple in stream order, one entry a shard on its device,
whose ``gather(device)`` concatenates them. ``mesh=None`` keeps the
one-device call, where the device follows the tensors.

Inputs: frames (n, B, H, W, 3) uint8 (or float in [0, 1] on the CPU),
corners or seeds (n, 4, 2), one set per stream.
"""

from __future__ import annotations

import contextlib

import torch

from camkifu_tpu_torch.board.bf_auto import accept_detections, \
    detect_batch, rectify_track_streams
from camkifu_tpu_torch.config import cvconf, guiconf
from camkifu_tpu_torch.ops.lens import Lens, check_lens
from camkifu_tpu_torch.ops.warp import canonical_corners, homography_dlt, \
    warp_frames
from camkifu_tpu_torch.stone import sf_clustering, sf_meta
from camkifu_tpu_torch.utils.profiling import span


# -- the mesh ----------------------------------------------------------------

def make_mesh(devices=None) -> tuple[torch.device, ...]:
    """A 1-D mesh: an ordered tuple of devices, one shard of streams each.
    By default every visible card; a device may repeat (``["cpu"] * 4``,
    or one card twice), which splits the streams all the same."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device (no card is "
                         "visible: pass the devices)")
    return mesh


def stream_sharding(mesh, n_streams: int) -> tuple[slice, ...]:
    """The contiguous stream slices of ``P("stream")`` on a 1-D mesh, one a
    mesh entry. Like the reference's ``device_put`` onto that sharding, a
    count the mesh does not divide is refused."""
    k, rest = divmod(n_streams, len(mesh))
    if rest or not n_streams:
        raise ValueError(f"{n_streams} streams do not shard over a mesh of "
                         f"{len(mesh)}: the stream count must be divisible "
                         f"by the mesh size")
    return tuple(slice(i * k, (i + 1) * k) for i in range(len(mesh)))


def fit_mesh(mesh, n_streams: int) -> tuple[torch.device, ...]:
    """The longest prefix of ``mesh`` whose size divides ``n_streams``: the
    part of a machine's cards that ``stream_sharding`` accepts for that
    count (4 streams on 3 cards run on the first 2, on 8 cards on the
    first 4)."""
    mesh = tuple(mesh)
    if n_streams < 1 or not mesh:
        raise ValueError(f"no mesh fits {n_streams} streams on "
                         f"{len(mesh)} devices")
    k = next(k for k in range(min(len(mesh), n_streams), 0, -1)
             if n_streams % k == 0)
    return mesh[:k]


class Sharded(tuple):
    """Per-shard values in stream order: entry i holds mesh entry i's
    streams on its device, as a tensor with a leading stream axis or a
    NamedTuple of them (``sf_meta.MetaState``, a stacked ``Lens``).
    ``gather(device)`` concatenates the shards along the streams."""

    def gather(self, device=None):
        first = self[0]
        if device is None:
            device = _device_of(first)

        def cat(parts):
            if not isinstance(parts[0], torch.Tensor):
                return parts[0]
            return torch.cat([p.to(device) for p in parts])

        if isinstance(first, tuple):
            return type(first)(*(cat([p[f] for p in self])
                                 for f in range(len(first))))
        return cat(list(self))


def _device_of(value) -> torch.device:
    if isinstance(value, torch.Tensor):
        return value.device
    return next(v.device for v in value if isinstance(v, torch.Tensor))


def _upload(value, part: slice, device: torch.device):
    """One shard of ``value`` on ``device``: a tensor's streams ``part``, a
    NamedTuple field by field (a number, one value for every stream, stays
    as it is)."""
    if isinstance(value, torch.Tensor):
        return value[part].to(device, non_blocking=True)
    if isinstance(value, tuple):
        return type(value)(*(_upload(v, part, device) for v in value))
    return value


def shard(value, mesh) -> Sharded:
    """``value`` (a tensor or a NamedTuple of tensors with a leading
    stream axis) cut by ``stream_sharding`` and each shard copied to its
    mesh device; a ``Sharded`` already on the mesh passes through, each
    entry moved where it is not on its device."""
    if isinstance(value, Sharded):
        if len(value) != len(mesh):
            raise ValueError(f"{len(value)} shards for a mesh of "
                             f"{len(mesh)}")
        return Sharded(_upload(v, slice(None), d)
                       for v, d in zip(value, mesh))
    n = value.shape[0] if isinstance(value, torch.Tensor) else next(
        v.shape[0] for v in value if isinstance(v, torch.Tensor))
    return Sharded(_upload(value, part, d)
                   for part, d in zip(stream_sharding(mesh, n), mesh))


def _on(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _run_sharded(mesh, body, *args):
    """``body`` on every shard, each under its own device, all launched
    before any result is read; each argument a ``Sharded`` (shard i's
    entry goes to shard i) or a value every shard takes. Returns the
    body's outputs, each a ``Sharded``."""
    outs = []
    for i, dev in enumerate(mesh):
        with _on(dev):
            outs.append(body(*(a[i] if isinstance(a, Sharded) else a
                               for a in args)))
    return tuple(Sharded(o[k] for o in outs) for k in range(len(outs[0])))


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
                     zone: int = cvconf.zone_size, *, mesh=None):
    """Classify the frames of n independent streams, each with its own
    fixed corners: ``_read_all_streams``. Returns (labels (n, B, g, g),
    confidence (n, B, g, g)); with a ``mesh``, each a ``Sharded``."""
    if mesh is None:
        return _read_all_streams(frames, corners, gsize, zone)
    return _run_sharded(mesh, _read_all_streams, shard(frames, mesh),
                        shard(corners, mesh), gsize, zone)


def multistream_init_states(n_streams: int, gsize: int = guiconf.gsize,
                            zone: int = cvconf.zone_size,
                            device="cuda", *, mesh=None):
    """Fresh vote-scan states of n streams on ``device`` (the card unless
    the caller asks for the CPU): every field of ``sf_meta.init_state``
    with a leading stream axis, ``frame_count`` (n,). With a ``mesh``: a
    ``Sharded`` of them, each shard's made on its device."""
    if mesh is not None:
        return Sharded(multistream_init_states(s.stop - s.start, gsize, zone,
                                               dev)
                       for s, dev in zip(stream_sharding(mesh, n_streams),
                                         mesh))
    one = sf_meta.init_state(gsize, zone, device)
    return sf_meta.MetaState(*(
        x[None].expand(n_streams, *x.shape).clone() for x in one))


def _read_meta(states, frames, corners, gsize, zone):
    n, b = frames.shape[0], frames.shape[1]
    canon = _warp_streams(frames, corners, gsize, zone)
    return sf_meta.scan_streams(states,
                                canon.reshape(n, b, *canon.shape[1:]),
                                gsize, zone)


def multistream_read_meta(states, frames: torch.Tensor,
                          corners: torch.Tensor, gsize: int = guiconf.gsize,
                          zone: int = cvconf.zone_size, *, mesh=None):
    """Config 5 with temporal tracking (the reference's
    ``_meta_all_streams`` under a mesh): ``sf_meta.read_batch`` of n
    fixed-camera streams at once, each with its own vote and background
    state (``multistream_init_states``) and its own corners. One warp
    launch, then the stream-batched vote scan, on each shard. Returns
    (states, labels (n, B, g, g), conf (n, B, g, g), agitation (n, B));
    with a ``mesh``, each a ``Sharded`` (``states`` may be one already)."""
    with span("camkifu.multistream_read_meta"):
        if mesh is None:
            return _read_meta(states, frames, corners, gsize, zone)
        return _run_sharded(mesh, _read_meta, shard(states, mesh),
                            shard(frames, mesh), shard(corners, mesh), gsize,
                            zone)


def _track_read(states, frames, seeds, lenses, gsize, zone, redetect=False):
    if redetect:
        detected, scores = detect_batch(frames[:, 0], gsize=gsize)
        seeds = accept_detections(detected, scores, seeds)
    canon, corners, sharp, align, new_seeds = rectify_track_streams(
        frames, seeds, gsize=gsize, zone=zone, lenses=lenses)
    new_states, labels, conf, agitation = sf_meta.scan_streams(
        states, canon, gsize, zone)
    out = (new_states, labels, conf, agitation, corners, sharp, align,
           new_seeds)
    return out + (detected, scores) if redetect else out


def multistream_track_read(states, frames: torch.Tensor, seeds: torch.Tensor,
                           gsize: int = guiconf.gsize,
                           zone: int = cvconf.zone_size,
                           lenses: Lens | None = None, *, mesh=None,
                           redetect: bool = False):
    """Config 4 × config 5 (the reference's ``_track_all_streams`` under a
    mesh): the fused tracking engine (per-frame board tracking,
    rectification, classification, vote scan) over n independent handheld
    streams, the stream-batched tracker (one warp launch a chunk for every
    stream) then the stream-batched vote scan, on each shard. Each
    stream's seed (its last detection or previous ``new_seed``)
    re-anchors at its own last frame. Without ``redetect`` nothing in the
    call waits for the device. ``lenses``: None, or each stream's camera
    as one stacked ``ops.lens.Lens`` (``stack_lenses``, made once and held
    across calls; independent streams come from different cameras; with a
    mesh it may be ``shard``ed once), or one ``Lens`` of numbers for all.

    ``redetect``: first find every stream's board again on its first frame
    (``bf_auto.detect_batch``, each shard its own streams); a stream whose
    detection is accepted (``bf_auto.accept_detections``: finite, scoring
    at least ``DETECT_MIN_SCORE``) is tracked from the detected corners,
    the others from their carried seeds, chosen on the device. The caller
    keeps the cadence (a runtime re-detects every ``cvconf.bf_period``
    batches). The call then waits for the device: once on the
    shared-canvas verdicts, and twice a frame of a chunk that fails
    validation (the per-frame refine's two route tests). Pinhole cameras
    only: with ``lenses`` it raises, as detection runs on raw frames.

    Returns (states, labels (n, B, g, g), conf, agitation (n, B), corners
    (n, B, 4, 2), sharpness (n, B), align (n, B), new_seeds (n, 4, 2)),
    and with ``redetect`` also (detected (n, 4, 2), scores (n,)); with a
    ``mesh``, each a ``Sharded``.
    """
    if redetect and lenses is not None:
        raise ValueError("multistream_track_read: redetect finds boards on "
                         "pinhole frames only; it takes no lenses")
    with span("camkifu.multistream_track_read"):
        if mesh is None:
            return _track_read(states, frames, seeds, lenses, gsize, zone,
                               redetect)
        if not isinstance(lenses, Sharded):
            check_lens(lenses)
        if isinstance(lenses, Sharded) or (
                lenses is not None and isinstance(lenses.k1, torch.Tensor)):
            lenses = shard(lenses, mesh)
        return _run_sharded(mesh, _track_read, shard(states, mesh),
                            shard(frames, mesh), shard(seeds, mesh), lenses,
                            gsize, zone, redetect)

"""Vision constants the port reads, copied from camkifu_tpu/config/cvconf.py.

The constants, the ``VisionConfig`` dataclass and the finder registries
(``bfinders`` / ``sfinders``, the port's classes in the reference's order,
without the finders not ported yet: ``SfBgSub`` and ``SfNeural``).
``tests/test_torch_host_copies.py`` holds every value to the reference.
"""

from __future__ import annotations

import dataclasses

from camkifu_tpu_torch.config import guiconf

#: Pixels per intersection cell of the canonical image: intersection (r, c)
#: sits at pixel ((r + 0.5) * zone_size, (c + 0.5) * zone_size).
zone_size = 16
canonical_size = guiconf.gsize * zone_size      # 304 for gsize=19


def canonical_size_for(gsize: int, zone: int = zone_size) -> int:
    return gsize * zone


#: Frames per batch in film (recorded video) mode.
frame_batch = 32

#: Temporal vote window F: votes decay with rate (1 - 1/F).
vote_window = 7

#: Vote mass required before a reading commits.
vote_threshold = 4

#: Minimum per-intersection confidence for a reading to cast a vote.
vote_min_conf = 0.25

#: Fraction of changed pixels above which a frame is "agitated" (hand over
#: the board) and stone reading is gated off.
agitation_threshold = 0.012

#: EMA coefficient of the background model used for agitation.
background_ema = 0.05

#: Board re-detection period, in frames, when tracking is stable.
bf_period = 8

#: Edge/Hough working resolution (detection runs on a downsampled frame).
bf_resolution = 256

#: Theta and rho bins of the Hough accumulator.
hough_thetas = 128
hough_rhos = 256

#: Top-K edge pixels fed to the Hough vote.
hough_topk = 4096


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    gsize: int = guiconf.gsize
    zone_size: int = zone_size
    frame_batch: int = frame_batch
    vote_window: int = vote_window
    vote_threshold: int = vote_threshold
    vote_min_conf: float = vote_min_conf
    agitation_threshold: float = agitation_threshold
    background_ema: float = background_ema
    bf_period: int = bf_period
    bf_resolution: int = bf_resolution
    hough_thetas: int = hough_thetas
    hough_rhos: int = hough_rhos
    hough_topk: int = hough_topk

    @property
    def canonical_size(self) -> int:
        return self.gsize * self.zone_size


DEFAULT = VisionConfig()


# ---------------------------------------------------------------------------
# Algorithm registries (populated lazily to avoid import cycles; finders import
# this module for constants). First entry of each list = default in the GUI,
# mirroring the reference's convention.
# ---------------------------------------------------------------------------

def bfinders():
    from camkifu_tpu_torch.board.bf_auto import BoardFinderAuto
    from camkifu_tpu_torch.board.bf_manual import BoardFinderManual

    return [BoardFinderAuto, BoardFinderManual]


def sfinders():
    from camkifu_tpu_torch.stone.sf_bgsub import SfBgSub
    from camkifu_tpu_torch.stone.sf_clustering import SfClustering
    from camkifu_tpu_torch.stone.sf_contours import SfContours
    from camkifu_tpu_torch.stone.sf_meta import SfMeta
    from camkifu_tpu_torch.stone.sf_neural import SfNeural
    from camkifu_tpu_torch.stone.sf_tuto import SfTuto

    return [SfMeta, SfClustering, SfContours, SfBgSub, SfNeural, SfTuto]

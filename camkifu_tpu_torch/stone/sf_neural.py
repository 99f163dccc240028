"""SfNeural (port of camkifu_tpu/stone/sf_neural.py): the CNN of
``models.neural`` classifying every intersection patch of a batch of
frames B/W/E, and the host finder class, which loads the user's checkpoint
or trains one on rendered boards the first time it is chosen.
"""

from __future__ import annotations

import numpy as np
import torch

from camkifu_tpu_torch.config import cvconf, guiconf
from camkifu_tpu_torch.core.feeder import to_device
from camkifu_tpu_torch.models import neural
from camkifu_tpu_torch.ops.warp import warp_batch_chunked, warp_batch_fixed
from camkifu_tpu_torch.ops.zones import extract_zones
from camkifu_tpu_torch.stone.stonesfinder import StonesFinder


def zone_probs(model: neural.PatchNet, canon: torch.Tensor,
               gsize: int = guiconf.gsize,
               zone: int = cvconf.zone_size) -> torch.Tensor:
    """Canonical images (..., S, S, 3) in [0, 1] → the net's softmax over
    E/B/W at every intersection (..., g, g, 3), all patches in one
    forward."""
    lead = canon.shape[:-3]
    patches = extract_zones(canon, gsize, zone).reshape(-1, zone, zone, 3)
    with torch.no_grad():
        probs = torch.softmax(model(patches), dim=-1)
    return probs.reshape(*lead, gsize, gsize, 3)


def classify_batch_neural(model: neural.PatchNet, frames: torch.Tensor,
                          corners: torch.Tensor, gsize: int = guiconf.gsize,
                          zone: int = cvconf.zone_size, lens=None):
    """(B, H, W, 3) uint8 frames + (4, 2) fixed or (B, 4, 2) per-frame
    corners (raw frame positions; ``lens`` the camera's ``ops.lens.Lens``
    or None) → (labels (B, g, g) int8, conf (B, g, g) float32, the top
    softmax probability)."""
    scale = 1.0 / 255.0 if frames.dtype == torch.uint8 else 1.0
    warp = warp_batch_chunked if corners.ndim == 3 else warp_batch_fixed
    canon = warp(frames, corners.to(torch.float32), gsize, zone, scale=scale,
                 lens=lens)
    conf, labels = torch.max(zone_probs(model, canon, gsize, zone), dim=-1)
    return labels.to(torch.int8), conf


def get_or_train_params(log=None, quick: bool = False, device="cuda"):
    """The user's checkpoint on ``device``, or a net bootstrap-trained on
    rendered boards (48 boards and 4 epochs, 8 and 2 when ``quick``) and
    saved for next time; if the save fails the in-memory net is kept.

    Choosing the 'neural' finder is an explicit request for the net, so a
    missing checkpoint trains one rather than reading nothing (no
    pretrained checkpoint ships)."""
    model = neural.load_params(device=device)
    if model is not None:
        return model
    patches, labels = neural.harvest_patches(n_boards=8 if quick else 48,
                                             device=device)
    model, acc = neural.train(patches, labels, epochs=2 if quick else 4,
                              log=log)
    if log:
        log(f"sf_neural bootstrap training accuracy: {acc:.4f}")
    try:
        neural.save_params(model)
    except OSError:
        pass   # checkpoint dir may be unwritable; keep the in-memory net
    return model


class SfNeural(StonesFinder):
    label = "neural"

    def __init__(self, vmanager):
        super().__init__(vmanager)
        self.params = get_or_train_params(
            log=lambda msg: self.metadata.__setitem__("train", msg),
            device=getattr(vmanager, "device", "cuda"))

    def _find(self, frames, corners):
        return classify_batch_neural(
            self.params, frames,
            to_device(np.asarray(corners, np.float32), frames.device),
            gsize=self.gsize, lens=self._bf_lens())

"""Fixed cameras: every batch of S streams × B frames is one
``parallel.mesh.multistream_read_meta`` call (one warp launch for all
frames, then the stream-batched vote scan), each stream with its own
corners and vote state. Set-up finds each board once, as a fixed camera
does, on its stream's first frame (``bf_auto.detect_batch``, one call);
from then on the states pass from batch to batch as the program returns
them, on the device, through every pass over the pool."""

from __future__ import annotations

import torch

from camkifu_tpu_torch.board.bf_auto import detect_batch
from camkifu_tpu_torch.parallel import mesh

ENTRY = "camkifu_tpu_torch.parallel.mesh.multistream_read_meta"


class Program:
    def __init__(self, cfg: dict, mix: dict, inputs: dict, device):
        self.pool = inputs["pool"]
        self.n = cfg["streams"]
        self.gsize, self.zone = cfg["gsize"], cfg["zone"]
        self.device = torch.device(device)
        corners, _ = detect_batch(self.pool[0, :, 0].contiguous(),
                                  gsize=self.gsize)
        self.corners = self.anchor = corners.to(torch.float32).contiguous()
        self.states = mesh.multistream_init_states(
            self.n, self.gsize, self.zone, device=self.device)

    def state(self) -> dict:
        """Everything the next batch starts from."""
        return {**dict(zip(self.states._fields, self.states)),
                "corners": self.corners}

    def step(self, k: int) -> dict:
        """Pool batch ``k`` → its outputs, device tensors, ``labels`` (S,
        B, g, g) first."""
        self.states, labels, conf, agitation = mesh.multistream_read_meta(
            self.states, self.pool[k], self.corners, self.gsize, self.zone)
        return {"labels": labels, "conf": conf, "agitation": agitation,
                **{f"state_{f}": v for f, v in
                   zip(self.states._fields, self.states)}}

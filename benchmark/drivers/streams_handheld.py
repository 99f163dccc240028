"""Handheld cameras: every batch of S streams × B frames is one
``parallel.mesh.multistream_track_read`` call (the stream-batched
tracker, which finds every frame's board again from the one before, one
warp launch a chunk for every stream, then the stream-batched vote scan).
Set-up finds each board on its stream's first frame
(``bf_auto.detect_batch``); from then on the vote states and the seeds
pass from batch to batch as the program returns them, on the device,
through every pass over the pool."""

from __future__ import annotations

import torch

from camkifu_tpu_torch.board.bf_auto import detect_batch
from camkifu_tpu_torch.ops.lens import make_lens, stack_lenses
from camkifu_tpu_torch.parallel import mesh

ENTRY = "camkifu_tpu_torch.parallel.mesh.multistream_track_read"


class Program:
    def __init__(self, cfg: dict, mix: dict, inputs: dict, device):
        self.pool = inputs["pool"]
        self.n = cfg["streams"]
        self.gsize, self.zone = cfg["gsize"], cfg["zone"]
        self.device = torch.device(device)
        corners, _ = detect_batch(self.pool[0, :, 0].contiguous(),
                                  gsize=self.gsize)
        self.seeds = self.anchor = corners.to(torch.float32).contiguous()
        # A lens a camera, as its known calibration, where the
        # configuration gives the cameras lenses.
        self.lenses = None
        if "k1_range" in cfg["camera"]:
            hw = tuple(cfg["frame_hw"])
            self.lenses = stack_lenses(
                [make_lens(float(k1), hw) for k1 in inputs["k1"].tolist()],
                self.device)
        self.states = mesh.multistream_init_states(
            self.n, self.gsize, self.zone, device=self.device)

    def state(self) -> dict:
        """Everything the next batch starts from."""
        return {**dict(zip(self.states._fields, self.states)),
                "seeds": self.seeds}

    def step(self, k: int) -> dict:
        (self.states, labels, conf, agitation, corners, sharp, align,
         self.seeds) = mesh.multistream_track_read(
            self.states, self.pool[k], self.seeds, self.gsize, self.zone,
            lenses=self.lenses)
        return {"labels": labels, "conf": conf, "agitation": agitation,
                "corners": corners, "sharpness": sharp, "align": align,
                "seeds": self.seeds,
                **{f"state_{f}": v for f, v in
                   zip(self.states._fields, self.states)}}

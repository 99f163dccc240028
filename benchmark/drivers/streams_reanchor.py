"""Handheld cameras that find their boards again at the runtime's
cadence: each batch of S streams × B frames is one
``parallel.mesh.multistream_track_read`` call. Pool batches whose index
is a multiple of the configuration's ``reanchor.period_batches`` (the
port's ``cvconf.bf_period``) pass ``redetect=True``: the call first runs
``bf_auto.detect_batch`` over every stream's first frame and tracks a
stream from its detected corners where ``bf_auto.accept_detections``
takes them, from its carried seed elsewhere. Every batch then runs the
stream-batched tracker and vote scan, as ``streams_handheld.py`` runs
them, whose set-up this is: each board found on its stream's first frame,
fresh vote states. A batch that does not re-detect gives empty
``detected`` (0, 4, 2) and ``scores`` (0,)."""

from __future__ import annotations

from benchmark.drivers import streams_handheld
from camkifu_tpu_torch.parallel import mesh

ENTRY = streams_handheld.ENTRY


class Program(streams_handheld.Program):
    def __init__(self, cfg: dict, mix: dict, inputs: dict, device):
        super().__init__(cfg, mix, inputs, device)
        self.period = cfg["reanchor"]["period_batches"]

    def step(self, k: int) -> dict:
        if k % self.period:
            out = super().step(k)
            return {**out, "detected": self.seeds.new_empty((0, 4, 2)),
                    "scores": self.seeds.new_empty((0,))}
        (self.states, labels, conf, agitation, corners, sharp, align,
         self.seeds, detected, scores) = mesh.multistream_track_read(
            self.states, self.pool[k], self.seeds, self.gsize, self.zone,
            lenses=self.lenses, redetect=True)
        return {"labels": labels, "conf": conf, "agitation": agitation,
                "corners": corners, "sharpness": sharp, "align": align,
                "seeds": self.seeds, "detected": detected, "scores": scores,
                **{f"state_{f}": v for f, v in
                   zip(self.states._fields, self.states)}}

"""filecheck — batch scoring harness: pipeline vs a reference SGF (port of
camkifu_tpu/filecheck.py).

    python -m camkifu_tpu_torch.filecheck synth:40:hard
    python -m camkifu_tpu_torch.filecheck synth:24:caps auto

renders a game with known ground truth on the card (``utils.synth``), reads
it and prints the move-agreement report; it exits 0 at the reference's
PASS bar (agreement ≥ 0.99), the north-star accuracy metric.

``run_pipeline`` is the recorded-video path on tensors:

  uint8 frames, in batches (device tensors stacked on their device, numpy
  frames copied there)
    → first batch only: bf_auto.detect_batch_stable → fixed corners (4, 2)
    → sf_meta.read_batch (warp kernel → zone stats → contours + clustering
      → motion gate → vote scan, the trained net as a third voter when a
      checkpoint exists), or pipeline.read_board_batch without votes
    → stable labels (B, g, g) → host MoveExtractor → moves

Batching and move extraction are the reference's host code, copied into
the port (``batched`` here, ``core.gamesync.MoveExtractor``).

``run_runtime`` drives the full vision runtime instead: ``VManagerSeq``
with ``BoardFinderAuto`` (detection, per-frame tracking, trip-wires, lens
calibration at the first anchor) and ``SfMeta`` (fused tracking and votes,
pose veto, bulk self-correction) over in-memory frames.

Not ported, each raising ``NotImplementedError``: reading a video file
(cv2's decoder), the ``real`` and ``gauntlet`` specs (an mp4 round trip
through cv2's encoder, ``synth.encode_roundtrip``) and ``--oracle cv2`` /
``both`` (the OpenCV pipeline ``camkifu_tpu/oracle_cv2.py``). The neural
voter's checkpoint is loaded strictly: a missing one reads without it, any
other failure raises, where the reference's bare ``except`` reads on.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from camkifu_tpu_torch.board import bf_auto
from camkifu_tpu_torch.config import cvconf, guiconf
from camkifu_tpu_torch.core.gamesync import MoveExtractor, score_moves
from camkifu_tpu_torch.gamemodel.kifu import Kifu
from camkifu_tpu_torch.stone import sf_meta


class KifuChecker:
    """Align a detected move sequence against a reference kifu and report.

    ``report()`` returns the metric dict; ``diff_lines()`` lists per-move
    disagreements for debugging (copied from camkifu_tpu/filecheck.py).
    """

    def __init__(self, reference_moves):
        self.reference = list(reference_moves)

    def report(self, detected) -> dict:
        return score_moves(list(detected), self.reference)

    def diff_lines(self, detected) -> list[str]:
        """Per-move disagreements, derived from the SAME edit-distance
        alignment as report() — a positional zip would list every move after
        an early miss as wrong, contradicting the counts."""
        detected = list(detected)
        ops = score_moves(detected, self.reference, with_ops=True)["ops"]
        out = []
        for kind, di, rj in ops:
            if kind == "wrong":
                out.append(f"ref move {rj + 1}: expected "
                           f"{self.reference[rj]!r}, got {detected[di]!r}")
            elif kind == "missing":
                out.append(f"ref move {rj + 1}: missing "
                           f"{self.reference[rj]!r}")
            elif kind == "extra":
                out.append(f"extra detected move: {detected[di]!r}")
        return out


def iter_video_frames(path: str, bounds=(0.0, 1.0)):
    """Decoding a video file needs cv2's ``VideoCapture``, which the port
    does not use: it raises."""
    raise NotImplementedError(
        f"cannot read {path!r}: video decode goes through cv2 "
        f"(camkifu_tpu/filecheck.py iter_video_frames), which the port does "
        f"not use; pass frames as arrays to run_pipeline, or a synth: spec")


def batched(iterator, size: int):
    """Group an iterator into (stacked batch, count) batches, padding the
    tail by repeating the last frame (copied from camkifu_tpu/filecheck.py).
    Tensors are stacked on their device, numpy frames into an ndarray."""
    buf = []

    def stack(items):
        return torch.stack(items) if isinstance(items[0], torch.Tensor) \
            else np.stack(items)

    for item in iterator:
        buf.append(item)
        if len(buf) == size:
            yield stack(buf), size
            buf = []
    if buf:
        n = len(buf)
        while len(buf) < size:
            buf.append(buf[-1])
        yield stack(buf), n


def run_pipeline(frames_iter, corners: np.ndarray | None = None,
                 batch: int = cvconf.frame_batch,
                 gsize: int = guiconf.gsize,
                 extractor: MoveExtractor | None = None,
                 use_meta: bool = True,
                 use_neural: bool = True,
                 progress=None, device="cuda"):
    """Drive the pipeline over all frames on ``device`` (the card unless
    the caller asks for the CPU); return (extractor, stats).

    frames_iter yields (H, W, 3) uint8 frames: numpy arrays, or tensors,
    which are stacked on their own device. corners=None → automatic board
    detection, once, on the first batch (``detect_batch_stable``: a fixed
    camera); otherwise the fixed (4, 2) corner set is used. With
    ``use_meta`` the SfMeta vote scan reads (the tail batch padded by
    repeating its last frame, the padding casting no votes), joined by
    the trained net when ``use_neural`` and a checkpoint exists; without
    it, per-frame clustering (``pipeline.read_board_batch``). ``progress``
    is called with the frame count after each batch.
    """
    from camkifu_tpu_torch import pipeline

    device = torch.device(device)
    extractor = extractor or MoveExtractor(gsize=gsize)
    corners_dev = None if corners is None else torch.as_tensor(
        np.asarray(corners, np.float32), device=device)
    state = neural_params = None
    n_frames = 0
    t0 = time.perf_counter()
    for fb, n in batched(frames_iter, batch):
        frames = torch.as_tensor(fb).to(device)
        if corners_dev is None:
            corners_dev = bf_auto.detect_batch_stable(frames, gsize=gsize)
        if use_meta:
            if state is None:
                state = sf_meta.init_state(gsize=gsize, device=device)
                # The trained net at sf_meta.NEURAL_CKPT, or None when none
                # was trained; a checkpoint that fails to load raises.
                neural_params = sf_meta._neural_params(device) \
                    if use_neural else None
            state, labels, _conf, _agit = sf_meta.read_batch(
                state, frames, corners_dev, gsize=gsize,
                neural_params=neural_params,
                valid_count=n if n < frames.shape[0] else None)
        else:
            labels, _conf = pipeline.read_board_batch(frames, corners_dev,
                                                      gsize=gsize)
        labels = labels.cpu().numpy()
        for i in range(n):
            extractor.advance(labels[i])
        n_frames += n
        if progress:
            progress(n_frames)
    dt = time.perf_counter() - t0
    return extractor, {"frames": n_frames, "seconds": dt,
                       "fps": n_frames / dt if dt > 0 else 0.0,
                       "corners": (None if corners_dev is None else
                                   corners_dev.cpu().numpy().tolist())}


def run_runtime(frames, batch: int = 16, gsize: int = guiconf.gsize,
                device="cuda"):
    """Drive the FULL vision runtime — VManagerSeq hosting BoardFinderAuto
    (per-frame 4-DoF corner tracking, trip-wires, forced re-detection) and
    SfMeta (temporal votes, pending-capture filter, bulk self-correction) —
    over in-memory frames on ``device`` (the card unless the caller asks
    for the CPU); return (detected_moves, stats).

    This is the moving-camera path that the fixed-corner pipeline
    (run_pipeline) cannot represent: corners are re-measured every frame
    and the finder hosts react to trips.
    """
    from camkifu_tpu_torch.board.bf_auto import BoardFinderAuto
    from camkifu_tpu_torch.core.capture import ArrayCapture
    from camkifu_tpu_torch.core.controllerv import ControllerVSeq
    from camkifu_tpu_torch.core.vmanager import VManagerSeq
    from camkifu_tpu_torch.stone.sf_meta import SfMeta

    controller = ControllerVSeq(gsize=gsize)
    vm = VManagerSeq(controller, video=None, bf_class=BoardFinderAuto,
                     sf_class=SfMeta, batch=batch, device=device)
    vm.capture = ArrayCapture(frames)
    vm.instantiate_finders()
    t0 = time.perf_counter()
    vm.run()
    dt = time.perf_counter() - t0
    n = len(frames)
    return controller.kifu.moves(), {
        "frames": n, "seconds": dt, "fps": n / dt if dt > 0 else 0.0}


def check(video_spec: str, ref_sgf: str | None, corners=None,
          batch: int = cvconf.frame_batch, use_meta: bool = True,
          use_neural: bool = True, oracle: str = "tpu",
          device="cuda") -> dict:
    """Run the harness on ``device`` (the card unless the caller asks for
    the CPU); return the score report dict.

    video_spec: ``synth:N[:seed][:hard|real|gauntlet][:flicker][:caps]
    [:t3][:palette]`` renders an N-move game with known ground truth at
    720p (the reference's spec tokens and errors); a video path needs cv2
    and raises. oracle: "tpu" is the port's pipeline (the reference's name
    for it); "cv2" and "both" need the reference's OpenCV pipeline and
    raise.
    """
    from camkifu_tpu_torch.utils import synth

    gsize = guiconf.gsize
    if video_spec.startswith("synth:"):
        parts = video_spec.split(":")
        n_moves = int(parts[1])
        rest = parts[2:]
        if "gauntlet" in rest:
            # Every adversity at once through the FULL runtime; fixed-corner
            # modes do not apply.
            extra = [p for p in rest if p != "gauntlet" and not p.isdigit()]
            if extra or oracle != "tpu" or corners is not None \
                    or not use_meta:
                raise ValueError(
                    "the gauntlet scenario is auto-detected, tracked and "
                    "meta-voted by construction: no extra tokens, "
                    "--corners, --no-meta, or --oracle cv2/both "
                    f"(got tokens {extra!r}, oracle={oracle!r})")
            g_seed = next((int(p) for p in rest if p.isdigit()), 11)
            moves, frames_factory = synth.gauntlet_scenario(
                n_moves, seed=g_seed, device=device)
            # The reference's scenario ends with the mp4 round trip, which
            # needs cv2: this raises before anything is rendered.
            frames = synth.encode_roundtrip(frames_factory())
            checker = KifuChecker(moves)
            # The scenario's pacing is authored against the 16-frame
            # re-anchor cadence: batch is fixed, not the --batch flag.
            detected, stats = run_runtime(frames, batch=16, device=device)
            report = checker.report(detected)
            report.update(stats)
            report["diff"] = checker.diff_lines(detected)[:20]
            return report
        seed = next((int(p) for p in rest if p.isdigit()), 7)
        real = "real" in rest
        hard = "hard" in rest or real
        hard_kw = dict(stone_jitter=0.07, light_gradient=0.3,
                       blur_sigma=1.2, shadow=0.18) if hard else {}
        game_kw = {}
        if real:
            hard_kw.update(wood_texture=0.10, vignette=0.22)
            game_kw["hand_frames"] = 2
        if "flicker" in rest:
            # Auto-exposure hunting: per-frame global gain walk ±15%.
            game_kw["flicker"] = 0.15
        if "caps" in rest:
            # Capture-rich game, captured stones lingering past the
            # bulk-correction threshold.
            from camkifu_tpu_torch.stone.stonesfinder import \
                BULK_CORRECT_AFTER
            game_kw["removal_lag"] = BULK_CORRECT_AFTER + 20
        if "t3" in rest:
            # Specular glare on stone tops and shot/read sensor noise.
            hard_kw.update(glare=0.5, shot_noise=0.4)
        palette = next((p for p in rest if p in synth.PALETTES), None)
        if palette:
            hard_kw["palette"] = palette
        bad = [p for p in rest
               if not (p.isdigit()
                       or p in ("hard", "real", "flicker", "caps", "t3")
                       or p in synth.PALETTES)]
        if bad:
            raise ValueError(
                f"unknown synth spec token(s) {bad}: expected a seed, "
                f"'hard'/'real'/'flicker'/'caps'/'t3', or a palette in "
                f"{sorted(synth.PALETTES)}")
        moves = (synth.capture_rich_moves(n_moves, seed=seed)
                 if "caps" in rest else
                 synth.sample_moves(n_moves, seed=seed))
        ref_moves = moves
        gt_corners = synth.default_corners((720, 1280))
        # With temporal votes a stone must persist ≈ the vote window before
        # it commits; the per-frame classifiers need no persistence.
        fpm = cvconf.vote_window + 3 if use_meta else 3

        def frames_factory():
            it = (f for f, _ in synth.render_game(
                moves, frames_per_move=fpm, frame_hw=(720, 1280), seed=seed,
                empty_leadin=6, device=device, **game_kw, **hard_kw))
            if real:
                return iter(synth.encode_roundtrip(it))
            return it
        if corners is None and ref_sgf != "auto":
            corners = gt_corners
    else:
        def frames_factory():
            return iter_video_frames(video_spec)
        if ref_sgf is None:
            raise ValueError("a reference SGF is required for video input")
        ref_kifu = Kifu.load(ref_sgf)
        ref_moves = ref_kifu.moves()
        # The reference SGF's SZ property is the authoritative board size.
        gsize = ref_kifu.gsize
    if oracle in ("cv2", "both"):
        raise NotImplementedError(
            f"--oracle {oracle} runs the independent OpenCV pipeline "
            f"(camkifu_tpu/oracle_cv2.py), which is cv2 by definition; the "
            f"port scores its own pipeline only (--oracle tpu)")

    checker = KifuChecker(ref_moves)
    extractor, stats = run_pipeline(frames_factory(), corners, batch=batch,
                                    gsize=gsize, use_meta=use_meta,
                                    use_neural=use_neural, device=device)
    stats.pop("corners", None)
    report = checker.report(extractor.moves)
    report.update(stats)
    report["rejected_readings"] = extractor.rejected
    report["diff"] = checker.diff_lines(extractor.moves)[:20]
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Score the vision pipeline against a reference SGF.")
    ap.add_argument("video",
                    help="synth:N[:seed][:hard|real|gauntlet][:flicker]"
                         "[:caps][:t3][:palette] (a video file needs cv2's "
                         "decoder, which the port does not use)")
    ap.add_argument("sgf", nargs="?", default=None,
                    help="reference SGF ('auto' with synth: to force "
                         "auto board detection)")
    ap.add_argument("--batch", type=int, default=cvconf.frame_batch)
    ap.add_argument("--corners", type=str, default=None,
                    help="8 comma-separated floats: x1,y1,...,x4,y4 "
                         "(tl,tr,br,bl) — manual board corners")
    ap.add_argument("--no-meta", action="store_true",
                    help="per-frame clustering only (no temporal votes)")
    ap.add_argument("--no-neural", action="store_true",
                    help="ablate the neural voter (it participates only "
                         "when a user-trained checkpoint exists)")
    ap.add_argument("--oracle", choices=("tpu", "cv2", "both"),
                    default="tpu",
                    help="the port's pipeline ('tpu', the reference's name "
                         "for it); 'cv2' and 'both' need cv2 and raise")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    corners = None
    if args.corners:
        vals = [float(v) for v in args.corners.split(",")]
        corners = np.array(vals, np.float32).reshape(4, 2)

    report = check(args.video, args.sgf, corners=corners, batch=args.batch,
                   use_meta=not args.no_meta, use_neural=not args.no_neural,
                   oracle=args.oracle, device=args.device)
    print(json.dumps(report, indent=2, default=float))
    ok = report["agreement"] >= 0.99
    print(f"\n{'PASS' if ok else 'FAIL'}: {report['good']}/{report['ref_moves']} "
          f"moves agree ({report['agreement']:.1%}), "
          f"{report['wrong']} wrong, {report['missing']} missing, "
          f"{report['extra']} extra @ {report['fps']:.0f} fps")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

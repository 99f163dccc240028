"""ckmain — application entry point.

Parity: ``src/ckmain.py`` (SURVEY §2.1/§3.1) — parse CLI (video source,
bounds crop, sgf file, finder overrides), build the GUI + vision controller +
vision manager, start vision, run the main loop. ``--nogui`` runs the
headless path (sequential manager + controller) used on machines without a
display and by batch processing.

Copied from camkifu_tpu/ckmain.py, on the port's runtime. Vision runs on
``--device`` (default the card), as in ``filecheck``. ``-v`` takes a camera
index or a video path, decoded on the host through cv2 (``--decoders``
workers for a file); a caller may also set in-memory frames as
``args.video``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from camkifu_tpu_torch.config import cvconf


def get_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="ckmain",
        description="Watch a Go game (camera or video) and record it as SGF.")
    ap.add_argument("-v", "--video", default="0",
                    help="camera index or video file path (default 0)")
    ap.add_argument("-b", "--bounds", type=float, nargs=2, default=(0.0, 1.0),
                    metavar=("F1", "F2"),
                    help="relative vertical crop of the frames, two floats in [0,1]")
    ap.add_argument("--sgf", default=None,
                    help="SGF file to record into (resumes if it exists)")
    ap.add_argument("--bf", default=None,
                    help="board finder (label or class name; default: first "
                         "registered)")
    ap.add_argument("--sf", default=None,
                    help="stones finder (label or class name)")
    ap.add_argument("--corners", default=None,
                    help="8 comma-separated floats x1,y1,..x4,y4 (tl,tr,br,bl)"
                         " — implies the manual board finder")
    ap.add_argument("--batch", type=int, default=cvconf.frame_batch,
                    help="frames per device batch")
    ap.add_argument("--decoders", type=int, default=1,
                    help="host decode workers for video files (film mode); "
                         ">1 enables segmented parallel decode")
    ap.add_argument("--nogui", action="store_true",
                    help="headless: process the whole video, save the SGF, exit")
    ap.add_argument("--gsize", default=None,
                    choices=("9", "13", "19", "auto"),
                    help="board size (default 19; 9 and 13 supported; "
                         "'auto' infers it from the footage)")
    ap.add_argument("--stats", default=None, metavar="PATH",
                    help="write structured per-batch stats (JSONL) here; "
                         "live mode adds frame-arrival latency per batch")
    ap.add_argument("--live-wait", type=float, default=None, metavar="S",
                    help="live mode: max seconds to wait for a full frame "
                         "batch before dispatching a partial one (lower = "
                         "lower frame→SGF latency, more padded compute)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for vision (default cuda; no CPU "
                         "fallback)")
    return ap


def _resolve(registry, name, default):
    if name is None:
        return default
    for cls in registry:
        if cls.label == name or cls.__name__ == name:
            return cls
    raise SystemExit(f"unknown finder {name!r}; available: "
                     f"{[c.label for c in registry]}")


def _infer_gsize(args) -> int:
    """Resolve ``--gsize auto``: probe the source once before the game
    model is built (board size shapes rules, kifu SZ, and every finder, so
    it must be known up front). Detection-based — works with any finder
    selection afterwards; falls back to 19 with a warning when no board is
    found in the probe frames."""
    from camkifu_tpu_torch.board.bf_auto import infer_gsize
    from camkifu_tpu_torch.core.capture import open_capture
    from camkifu_tpu_torch.core.feeder import to_device

    cap = open_capture(args.video, tuple(args.bounds))
    try:
        frames, _ = cap.read_batch(8)
    finally:
        cap.release()
    if len(frames) == 0:
        print("gsize auto: no frames readable — assuming 19",
              file=sys.stderr)
        return 19
    g, quals = infer_gsize(to_device(frames[len(frames) // 2],
                                     args.device))
    if g == 0:
        print(f"gsize auto: no board found in probe frame ({quals}) — "
              f"assuming 19", file=sys.stderr)
        return 19
    print(f"gsize auto: {g} (evidence {quals})")
    return g


def main(argv=None) -> int:
    args = get_argparser().parse_args(argv)
    if args.gsize == "auto":
        args.gsize = _infer_gsize(args)
    elif args.gsize is not None:
        args.gsize = int(args.gsize)

    bfs, sfs = cvconf.bfinders(), cvconf.sfinders()
    bf_class = _resolve(bfs, args.bf, bfs[0])
    sf_class = _resolve(sfs, args.sf, sfs[0])

    corners = None
    if args.corners:
        from camkifu_tpu_torch.board.bf_manual import BoardFinderManual
        corners = np.array([float(v) for v in args.corners.split(",")],
                           np.float32).reshape(4, 2)
        bf_class = BoardFinderManual

    if args.nogui:
        return main_headless(args, bf_class, sf_class, corners)
    return main_gui(args, bf_class, sf_class, corners)


def main_headless(args, bf_class, sf_class, corners) -> int:
    from camkifu_tpu_torch.core.controllerv import ControllerVSeq
    from camkifu_tpu_torch.core.vmanager import VManagerSeq

    kw = {"gsize": args.gsize} if args.gsize else {}
    controller = ControllerVSeq(sgffile=args.sgf, video=args.video,
                                bounds=tuple(args.bounds), **kw)
    errors: list[str] = []
    controller.listeners.append(
        lambda ev, *a: errors.append(str(a)) if ev == "error" else None)
    vm = VManagerSeq(controller, video=args.video, bounds=tuple(args.bounds),
                     bf_class=bf_class, sf_class=sf_class, batch=args.batch,
                     stats_path=args.stats, initial_corners=corners,
                     decoders=args.decoders, live_wait_s=args.live_wait,
                     device=args.device)
    vm.instantiate_finders()
    vm.run()
    moves = controller.kifu.moves()
    print(f"detected {len(moves)} moves "
          f"({vm.stones_finder.total_frames} frames)")
    if args.sgf:
        controller.kifu.save()
        print(f"saved {args.sgf}")
    else:
        from camkifu_tpu_torch.gamemodel import sgf
        print(sgf.serialize_tree(controller.kifu.game))
    if errors:
        print(f"({len(errors)} rules rejections during the run)",
              file=sys.stderr)
    return 0


def main_gui(args, bf_class, sf_class, corners) -> int:
    try:
        import tkinter
    except ImportError:
        print("tkinter unavailable — use --nogui", file=sys.stderr)
        return 2
    from camkifu_tpu_torch.core.controllerv import ControllerV
    from camkifu_tpu_torch.core.vmanager import VManager
    from camkifu_tpu_torch.gui.vui import VUI

    root = tkinter.Tk()
    root.title("camkifu-tpu")
    kw = {"gsize": args.gsize} if args.gsize else {}
    controller = ControllerV(sgffile=args.sgf, video=args.video,
                             bounds=tuple(args.bounds), **kw)
    vmanager = VManager(controller, video=args.video,
                        bounds=tuple(args.bounds), bf_class=bf_class,
                        sf_class=sf_class, batch=args.batch,
                        stats_path=args.stats, initial_corners=corners,
                        decoders=args.decoders, live_wait_s=args.live_wait,
                        device=args.device)
    ui = VUI(root, controller, vmanager)
    vmanager.vision_on()
    ui.mainloop()
    vmanager.vision_off()
    controller.close(autosave=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

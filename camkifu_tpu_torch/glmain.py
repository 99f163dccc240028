"""glmain — the standalone SGF editor (game model + GUI, no vision).

Parity: Golib's ``glmain.py`` (SURVEY §2.2) — the same goban GUI and game
model run as a plain SGF editor/browser.

Copied from camkifu_tpu/glmain.py, on the port's ``Controller`` and
``gui.ui.UI``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="glmain",
                                 description="SGF editor (no vision).")
    ap.add_argument("sgf", nargs="?", default=None, help="SGF file to open")
    args = ap.parse_args(argv)

    try:
        import tkinter
    except ImportError:
        print("tkinter unavailable", file=sys.stderr)
        return 2

    from camkifu_tpu_torch.core.controllerv import Controller
    from camkifu_tpu_torch.gui.ui import UI

    root = tkinter.Tk()
    root.title("glmain — SGF editor")
    controller = Controller(sgffile=args.sgf)
    ui = UI(root, controller)
    ui.mainloop()
    if controller.kifu.modified and controller.kifu.sgffile:
        controller.kifu.save()
    return 0


if __name__ == "__main__":
    sys.exit(main())

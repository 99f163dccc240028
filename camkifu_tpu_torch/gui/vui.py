"""VUI — the vision-aware GUI: Video menu + algorithm selection + status.

Parity: ``camkifu/vgui/vui.py`` (SURVEY §2.1) — adds to the Golib UI: a
"Video" menu with vision on/off, pause, next-frame step, a video-position
slider (file mode), and radio selection of the board/stones finder populated
from the cvconf registries (first entry = default). Drains the controller's
pipe() queue on the Tk main loop — the reference's threading contract.

Copied from camkifu_tpu/gui/vui.py; the finder radios list the port's
registries (``config.cvconf.bfinders`` / ``sfinders``).
"""

from __future__ import annotations

import tkinter as tk

from camkifu_tpu_torch.config import cvconf
from camkifu_tpu_torch.gui.ui import UI

PIPE_PERIOD_MS = 50


class VUI(UI):
    def __init__(self, master, controller, vmanager):
        self.vmanager = vmanager
        super().__init__(master, controller)
        self._video_menu()
        self._drain_pipe()

    def _video_menu(self) -> None:
        video = tk.Menu(self.menubar, tearoff=0)
        video.add_command(label="Vision ON",
                          command=lambda: self._api("on"))
        video.add_command(label="Vision OFF",
                          command=lambda: self._api("off"))
        video.add_command(label="Pause",
                          command=lambda: self._api("pause", True))
        video.add_command(label="Resume",
                          command=lambda: self._api("pause", False))
        video.add_command(label="Next frame",
                          command=lambda: self._api("next"))
        video.add_command(label="Show video window",
                          command=self._show_video_window)
        video.add_separator()

        self._bf_var = tk.StringVar(value=cvconf.bfinders()[0].label)
        bfmenu = tk.Menu(video, tearoff=0)
        for cls in cvconf.bfinders():
            bfmenu.add_radiobutton(
                label=cls.label, variable=self._bf_var, value=cls.label,
                command=lambda c=cls: self._api("bfselect", c.label))
        video.add_cascade(label="Board finder", menu=bfmenu)

        self._sf_var = tk.StringVar(value=cvconf.sfinders()[0].label)
        sfmenu = tk.Menu(video, tearoff=0)
        for cls in cvconf.sfinders():
            sfmenu.add_radiobutton(
                label=cls.label, variable=self._sf_var, value=cls.label,
                command=lambda c=cls: self._api("sfselect", c.label))
        video.add_cascade(label="Stones finder", menu=sfmenu)

        self.menubar.add_cascade(label="Video", menu=video)

        # Video position slider (file mode seek).
        self.position = tk.DoubleVar(value=0.0)
        self.slider = tk.Scale(self, from_=0.0, to=1.0, resolution=0.001,
                               orient="horizontal", showvalue=False,
                               variable=self.position,
                               command=lambda v: self._api("vidpos",
                                                           float(v)))
        self.slider.grid(row=3, column=0, columnspan=6, sticky="we")

    def _show_video_window(self) -> None:
        from camkifu_tpu_torch.gui.video_window import VideoWindow

        if getattr(self, "_video_window", None) is None \
                or not self._video_window.winfo_exists():
            self._video_window = VideoWindow(self.master, self.vmanager)
        else:
            self._video_window.deiconify()

    def _drain_pipe(self) -> None:
        """Execute queued vision commands on the Tk main thread and refresh
        the status/goban — the reference's pipe() discipline."""
        n = self.controller.process_pipe()
        if n:
            self.goban.redraw()
        sf = self.vmanager.stones_finder
        if sf is not None and sf.metadata:
            bits = [f"{k}={v}" for k, v in sorted(sf.metadata.items())]
            self.status.set("  ".join(bits))
        if self.vmanager.capture is not None:
            try:
                self.position.set(self.vmanager.capture.get_position())
            except Exception:
                pass
        self.master.after(PIPE_PERIOD_MS, self._drain_pipe)

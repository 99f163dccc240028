"""Video preview window: live frames + corner overlay + manual clicks.

Parity: the reference displays the camera feed in an OpenCV window with
overlays, and BoardFinderManual registers a mouse callback on it (SURVEY
§2.1 bf_manual, §3.2 `_show → imqueue → Tk thread imshow`). Here the frame
renders into a Tk Toplevel via PhotoImage/PPM (no extra dependencies);
clicks forward to the manual board finder in frame coordinates.

Copied from camkifu_tpu/gui/video_window.py. The overlay is drawn on the
manager's device (``core.imgutil.annotate_preview``): one upload of the
latest frame and one copy back a tick, at full size, before the display
stride, as the reference orders them.
"""

from __future__ import annotations

import tkinter as tk

import numpy as np

REFRESH_MS = 100
MAX_W = 960


def _to_photo(frame_rgb: np.ndarray) -> tk.PhotoImage:
    h, w = frame_rgb.shape[:2]
    header = f"P6 {w} {h} 255 ".encode()
    return tk.PhotoImage(data=header + frame_rgb.tobytes(), format="PPM")


class VideoWindow(tk.Toplevel):
    def __init__(self, master, vmanager):
        super().__init__(master)
        self.title("video")
        self.vmanager = vmanager
        self.scale = 1.0
        self.label = tk.Label(self)
        self.label.pack()
        self.label.bind("<Button-1>", self._on_click)
        self._photo = None
        self.protocol("WM_DELETE_WINDOW", self.withdraw)
        self._tick()

    def _tick(self) -> None:
        frame = getattr(self.vmanager, "last_frame", None)
        if frame is not None:
            frame = self._annotate(np.ascontiguousarray(frame))
            h, w = frame.shape[:2]
            if w > MAX_W:
                step = int(np.ceil(w / MAX_W))
                frame = frame[::step, ::step]
                self.scale = 1.0 / step
            else:
                self.scale = 1.0
            self._photo = _to_photo(frame)
            self.label.configure(image=self._photo)
        self.after(REFRESH_MS, self._tick)

    def _annotate(self, frame: np.ndarray) -> np.ndarray:
        from camkifu_tpu_torch.core.imgutil import annotate_preview

        bf = self.vmanager.board_finder
        if bf is None:
            return frame
        return annotate_preview(frame, bf.corners_array, bf.metadata,
                                self.vmanager.device).cpu().numpy()

    def _on_click(self, event) -> None:
        bf = self.vmanager.board_finder
        if bf is not None and hasattr(bf, "onclick"):
            bf.onclick(event.x / self.scale, event.y / self.scale)

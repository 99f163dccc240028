"""UI — the Tk shell: menus, navigation, goban.

Parity: ``golib/gui/ui.py`` (SURVEY §2.2) — menus (open/save), B/W put-mode
buttons, delete, game navigation (begin/back/forward/end, arrow keys), and
the goban canvas.

Copied from camkifu_tpu/gui/ui.py, on the port's controller and kifu.
"""

from __future__ import annotations

import tkinter as tk
from tkinter import filedialog, messagebox

from camkifu_tpu_torch.gamemodel.move import B, W
from camkifu_tpu_torch.gui.goban import Goban


class UI(tk.Frame):
    def __init__(self, master, controller):
        super().__init__(master)
        self.master = master
        self.controller = controller
        self.goban = Goban(self, controller)
        self.goban.grid(row=0, column=0, columnspan=6)

        self.status = tk.StringVar(value="ready")
        tk.Label(self, textvariable=self.status, anchor="w") \
            .grid(row=2, column=0, columnspan=6, sticky="we")

        self._nav_buttons()
        self._menus()
        self._keys()
        controller.listeners.append(self._on_event)
        self.pack()

    def _nav_buttons(self) -> None:
        cmds = [("|<", "beginning"), ("<", "backward"),
                (">", "forward"), (">|", "end")]
        for i, (label, cmd) in enumerate(cmds):
            tk.Button(self, text=label,
                      command=lambda c=cmd: self._api(c)) \
                .grid(row=1, column=i)
        tk.Button(self, text="B", command=lambda: self._set_color(B)) \
            .grid(row=1, column=4)
        tk.Button(self, text="W", command=lambda: self._set_color(W)) \
            .grid(row=1, column=5)

    def _menus(self) -> None:
        self.menubar = tk.Menu(self.master)
        filemenu = tk.Menu(self.menubar, tearoff=0)
        filemenu.add_command(label="Open SGF…", command=self._open)
        filemenu.add_command(label="Save", command=self._save)
        filemenu.add_command(label="Save As…", command=self._save_as)
        filemenu.add_separator()
        filemenu.add_command(label="Quit", command=self._quit)
        self.menubar.add_cascade(label="File", menu=filemenu)
        self.master.config(menu=self.menubar)

    def _keys(self) -> None:
        self.master.bind("<Left>", lambda e: self._api("backward"))
        self.master.bind("<Right>", lambda e: self._api("forward"))
        self.master.bind("<Home>", lambda e: self._api("beginning"))
        self.master.bind("<End>", lambda e: self._api("end"))

    # -- actions -----------------------------------------------------------

    def _api(self, command: str, *args) -> None:
        fn = self.controller.api.get(command)
        if fn:
            fn(*args)
        self.goban.redraw()

    def _set_color(self, color: str) -> None:
        self.goban.select_color = color
        self.status.set(f"placing {color}")

    def _open(self) -> None:
        path = filedialog.askopenfilename(filetypes=[("SGF", "*.sgf")])
        if path:
            from camkifu_tpu_torch.gamemodel.kifu import Kifu

            self.controller.kifu = Kifu.load(path)
            self.controller.nav.end()
            self.goban.redraw()

    def _save(self) -> None:
        if self.controller.kifu.sgffile:
            self.controller.save()
        else:
            self._save_as()

    def _save_as(self) -> None:
        path = filedialog.asksaveasfilename(defaultextension=".sgf",
                                            filetypes=[("SGF", "*.sgf")])
        if path:
            self.controller.save(path)

    def _quit(self) -> None:
        kifu = self.controller.kifu
        if kifu.modified and kifu.sgffile:
            if messagebox.askyesno("camkifu", "Save game before quitting?"):
                kifu.save()
        self.master.destroy()

    def _on_event(self, event: str, *args) -> None:
        if event == "error":
            self.status.set(f"error: {args[0] if args else '?'}")
        elif event == "append" and args:
            self.status.set(f"move {args[0]!r}")

    def mainloop(self, n: int = 0) -> None:
        self.master.mainloop(n)

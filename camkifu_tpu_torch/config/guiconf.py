"""Board geometry: the board size (copied from camkifu_tpu/config/guiconf.py;
the Tk canvas constants are left out, the port has no GUI)."""

# Board size (number of intersections per side). Reference default: 19.
gsize = 19

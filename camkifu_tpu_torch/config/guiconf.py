"""Board / GUI geometry constants (copied from
camkifu_tpu/config/guiconf.py)."""

# Board size (number of intersections per side). Reference default: 19.
gsize = 19

# Tk canvas geometry (used only by the optional GUI).
canvas_size = 620          # pixels, square goban canvas
stone_ratio = 0.45         # stone radius as a fraction of one grid step
background = "#B8803E"     # goban wood tone

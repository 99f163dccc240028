"""Host helpers of the port."""


def board_to_ascii(labels) -> str:
    """19×19 int label grid → printable goban ('.' empty, 'X' black,
    'O' white) — the standalone finder mains' debug output."""
    import numpy as np

    chars = np.array([".", "X", "O"])
    rows = ["".join(chars[np.asarray(labels)[r]]) for r in
            range(np.asarray(labels).shape[0])]
    return "\n".join(rows)

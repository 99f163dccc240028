"""A closed loop: a capture server draining its cameras' buffered frames.
Batch after batch of the pool, in order and wrapping, with ``in_flight``
batches enqueued at once: batch t + 1 is enqueued before batch t's labels
are read to the host. The state passes from batch to batch inside the
program."""

from __future__ import annotations

import collections


def run(program, mix: dict, rec, first: int) -> None:
    """Offer pool batches ``first``, ``first`` + 1, … (modulo the pool) to
    ``program`` until ``rec`` closes the window; ``rec`` times and records
    each batch (``benchmark/window.py``)."""
    pending = collections.deque()
    n_pool = mix["pool_batches"]

    def drain():
        while pending:
            rec.complete(pending.popleft())

    j = 0
    while rec.open():
        if rec.at_stretch_edge(j):
            drain()
            rec.toggle_stretch(j)
        k = (first + j) % n_pool
        before = program.state()
        t_in = rec.clock()
        out = program.step(k)
        pending.append(rec.enqueued(j, k, t_in, before, out))
        if len(pending) >= mix["in_flight"]:
            rec.complete(pending.popleft())
        j += 1
    drain()
    rec.close_stretch(j)

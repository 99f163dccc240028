"""The program's spans (``camkifu_tpu_torch.utils.profiling.span``): while
no profiler session records, one shared null context that never enters
``record_function``; under a CPU ``torch.profiler`` session, one entry
span a call of ``parallel.mesh``'s two stream entries (with a mesh too),
the scan's two spans and the tracker's inside it; the outputs bitwise
the same with and without the profiler; every span of the package named
``camkifu.*``, and no other tracing helper in the port."""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from camkifu_tpu_torch.parallel import mesh
from camkifu_tpu_torch.utils import profiling, still

torch.set_num_threads(1)

PACKAGE = Path(__file__).resolve().parent.parent / "camkifu_tpu_torch"

#: A tiny shape: 2 streams × 2 frames of a 9×9 board.
HW = (120, 216)
G, ZONE = 9, 16
N, B = 2, 2

ENTRY = {"fixed": "camkifu.multistream_read_meta",
         "handheld": "camkifu.multistream_track_read"}
SCAN = ("camkifu.scan_streams.classify", "camkifu.scan_streams.votes")
TRACK = "camkifu.rectify_track_streams"
#: Every span of the stream entries' own layers.
SPANS = {*ENTRY.values(), *SCAN, TRACK}
#: Detection's spans, on the stream path only with ``redetect``
#: (tests/test_torch_reanchor_spans.py).
DETECT = {"camkifu.detect_batch", "camkifu.detect_batch.coarse",
          "camkifu.detect_batch.refine", "camkifu.detect_batch.shared",
          "camkifu.detect_batch.refine_one"}


@functools.lru_cache(maxsize=1)
def _streams():
    """(frames (N, 2B, H, W, 3) uint8, corners (N, 4, 2)): two calls'
    frames of a still board a stream."""
    corners = still.default_corners(HW)
    labels = np.zeros((G, G), np.int8)
    labels[2, 3], labels[6, 5] = 1, 2
    frames = np.stack([np.stack([
        still.render_still(labels, HW, seed=10 * s + k, corners=corners)[0]
        for k in range(2 * B)]) for s in range(N)])
    return torch.from_numpy(frames), \
        torch.from_numpy(np.stack([corners] * N).astype(np.float32))


def _flat(outputs):
    """Every tensor of nested tuples (a ``MetaState``, a ``Sharded``)."""
    out = []
    for x in outputs:
        out.extend(_flat(x) if isinstance(x, tuple) else [x])
    return out


def _calls(kind: str, shards: int | None):
    """Two calls of the kind's entry, the states (and seeds) carried →
    the outputs of both, flattened."""
    frames, corners = _streams()
    devices = None if shards is None else mesh.make_mesh(["cpu"] * shards)
    states = mesh.multistream_init_states(N, G, ZONE, device="cpu",
                                          mesh=devices)
    seeds, outs = corners, []
    for k in range(2):
        f = frames[:, k * B:(k + 1) * B]
        if kind == "fixed":
            out = mesh.multistream_read_meta(states, f, corners, G, ZONE,
                                             mesh=devices)
        else:
            out = mesh.multistream_track_read(states, f, seeds, G, ZONE,
                                              mesh=devices)
            seeds = out[-1]
        states = out[0]
        outs.append(out)
    return _flat(tuple(outs))


@functools.lru_cache(maxsize=None)
def _run(kind: str, shards: int | None, profiled: bool):
    """``_calls``, alone or under a CPU profiler session → (outputs,
    [(name, start µs, end µs, names of its enclosing spans)] of the
    ``camkifu.`` host events, or None)."""
    if not profiled:
        return _calls(kind, shards), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = _calls(kind, shards)
    spans = []
    for e in prof.events():
        if e.name.startswith("camkifu."):
            up, parent = [], e.cpu_parent
            while parent is not None:
                up.append(parent.name)
                parent = parent.cpu_parent
            spans.append((e.name, e.time_range.start, e.time_range.end, up))
    return outs, spans


def test_without_a_profiler_span_never_enters_record_function(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    first = profiling.span("camkifu.a")
    assert profiling.span("camkifu.b") is first
    with first:
        pass
    _calls("fixed", None)
    _calls("handheld", None)
    assert entered == []
    # The same patch sees a span while a session records.
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("camkifu.a"):
            pass
    assert entered == ["camkifu.a"]


@pytest.mark.parametrize("shards", [None, 2])
@pytest.mark.parametrize("kind", ["fixed", "handheld"])
def test_one_entry_span_a_call_holds_the_layers_spans(kind, shards):
    _, spans = _run(kind, shards, True)
    entries = [(s, e) for n, s, e, _ in spans if n == ENTRY[kind]]
    assert len(entries) == 2
    per_call = {n: 0 for n in SPANS}
    for name, s, e, up in spans:
        per_call[name] += 1
        if name == ENTRY[kind]:
            assert up == []
            continue
        # Inside one entry span in time, and under it on the thread.
        assert any(s0 <= s and e <= e0 for s0, e0 in entries), name
        assert ENTRY[kind] in up, (name, up)
    runs = 2 * (shards or 1)
    assert per_call == {
        ENTRY["fixed"]: 2 if kind == "fixed" else 0,
        ENTRY["handheld"]: 2 if kind == "handheld" else 0,
        SCAN[0]: runs, SCAN[1]: runs,
        TRACK: runs if kind == "handheld" else 0}


@pytest.mark.parametrize("kind", ["fixed", "handheld"])
def test_outputs_bitwise_equal_with_and_without_the_profiler(kind):
    plain, _ = _run(kind, None, False)
    traced, _ = _run(kind, None, True)
    assert len(plain) == len(traced)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))


def test_every_span_is_named_camkifu_and_no_other_helper_traces():
    names, bare = set(), []
    for path in PACKAGE.rglob("*.py"):
        text = path.read_text()
        names.update(re.findall(r'\bspan\("([^"]*)"', text))
        bare += [(path.name, m) for m in re.findall(
            r'\bspan\((?!")[^)]*\)', text) if path.name != "profiling.py"]
        if path.name != "profiling.py":
            assert "record_function" not in text, path
    assert bare == []
    assert names == SPANS | DETECT
    assert all(n.startswith("camkifu.") for n in names)
    own = {n for n, v in vars(profiling).items()
           if getattr(v, "__module__", None) == profiling.__name__}
    assert own == {"BatchStats", "span"}

"""The renderer's sensor noise (``ops/cuda/pcg_normal_kernel.py`` and
``csrc/pcg_normal.cu``) on the CPU: the plain version is numpy's draw,
bit for bit, with and without shot noise; the kernel's float32 expression
written out op by op is numpy's; the committed tables are numpy's; and a
Python model of the kernel's single pass (tiles of runs of words taken in
order, each run's masks and table, their composition over warps and the
block, each tile's aggregate and inclusive value, the look-back over
windows of tiles that finish out of order, each run's entry and the walk
again from it) gives numpy's normals bit for bit, at the kernel's own
constants and at tiles of a few runs of a few words, where wedge
rejections and tail loops cross the runs' and tiles' edges and entries
spill past the tables."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from camkifu_tpu.utils import synth as jsynth
from camkifu_tpu_torch.ops.cuda import pcg_normal_kernel as pk
from camkifu_tpu_torch.utils import synth

torch.set_num_threads(1)

CSRC = Path(pk.__file__).resolve().parents[2] / "csrc"
MASK64 = (1 << 64) - 1
MASK128 = (1 << 128) - 1
MULT = 0x2360ED051FC65DA44385DF649FCCF645


def _header():
    text = (CSRC / "ziggurat_tables.cuh").read_text()

    def block(name, count):
        body = text.split(f"{name}[{count}]", 1)[1].split("= {", 1)[1]
        return [t.strip() for t in body.split("};", 1)[0].replace(
            "{", " ").replace("}", " ").replace("\n", " ").split(",")
            if t.strip()]

    ki = [int(t.rstrip("ul"), 16) for t in block("KI", 256)]
    wi = [float.fromhex(t) for t in block("WI", 256)]
    fi = [float.fromhex(t) for t in block("FI", 256)]
    r = float(re.search(r"NOR_R = ([0-9.]+);", text).group(1))
    inv_r = float(re.search(r"NOR_INV_R = ([0-9.]+);", text).group(1))
    ja = [int(t.rstrip("ul"), 16) for t in block("JUMP_A", 64)]
    jp = [int(t.rstrip("ul"), 16) for t in block("JUMP_P", 64)]
    jump_a = [ja[2 * i] << 64 | ja[2 * i + 1] for i in range(64)]
    jump_p = [jp[2 * i] << 64 | jp[2 * i + 1] for i in range(64)]
    return dict(ki=ki, wi=wi, fi=fi, r=r, inv_r=inv_r, jump_a=jump_a,
                jump_p=jump_p)


TABLES = _header()


def _kernel_constants() -> dict:
    src = (CSRC / "pcg_normal.cu").read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("RUN", "DEPTH", "THREADS", "LANES", "LOOK")}


def _state(seed: int, hw=(37, 23)):
    """A generator after a bounded-integer draw (as the renderer's table
    draw leaves it: a buffered 32-bit half), and its (state, inc)."""
    rng = np.random.default_rng(seed)
    rng.integers(-6, 6, (*hw, 1))
    st = rng.bit_generator.state["state"]
    return rng, st["state"], st["inc"]


def _frame(seed: int, hw=(45, 61)) -> np.ndarray:
    f = np.random.default_rng(100 + seed).integers(0, 256, (*hw, 3))
    f[:3] = 0
    f[-3:] = 255                            # clipped at both ends
    return f.astype(np.uint8)


# -- the plain version is numpy's draw ---------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("noise, shot", [(3.0, 0.0), (3.0, 0.4)])
def test_plain_version_is_numpys_draw(seed, noise, shot):
    """The reference's lines (camkifu_tpu/utils/synth.py:322-332) on the
    frame's own generator, against the plain version restored from the
    generator's (state, inc): bitwise, through the CPU dispatch too."""
    rng, state, inc = _state(seed)
    frame = _frame(seed)
    if shot:
        f = frame.astype(np.float32)
        std = np.sqrt(noise * noise + shot * f)
        want = np.clip(f + rng.standard_normal(f.shape).astype(np.float32)
                       * std, 0, 255).astype(np.uint8)
    else:
        want = np.clip(frame.astype(np.float32)
                       + rng.normal(0, noise, frame.shape), 0, 255
                       ).astype(np.uint8)
    got = pk.pcg_normal_noise_ref(torch.from_numpy(frame), state, inc, noise,
                                  shot)
    assert got.dtype == torch.uint8 and got.shape == frame.shape
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(pk.sensor_noise(torch.from_numpy(frame), state, inc,
                                       noise, shot), got)
    assert not np.array_equal(want, frame)


@pytest.mark.parametrize("shot", [0.0, 0.4])
def test_kernel_expression_op_by_op_is_numpys(shot):
    """The kernel's expression, each operation rounded on its own in the
    type the kernel uses (float64 without shot noise; float32 with it,
    noise² rounded from float64 once), against the plain version."""
    noise = 3.0
    _, state, inc = _state(3)
    frame = _frame(3, (64, 96))
    z = pk.generator(state, inc).standard_normal(frame.size)
    f = frame.reshape(-1)
    if shot:
        nn, gain = np.float32(noise * noise), np.float32(shot)
        ff = f.astype(np.float32)
        sd = np.sqrt(np.add(nn, np.multiply(gain, ff, dtype=np.float32),
                            dtype=np.float32), dtype=np.float32)
        v = np.add(ff, np.multiply(z.astype(np.float32), sd,
                                   dtype=np.float32), dtype=np.float32)
        v = np.minimum(np.maximum(v, np.float32(0)), np.float32(255))
    else:
        v = f.astype(np.float64) + (0.0 + noise * z)
        v = np.minimum(np.maximum(v, 0.0), 255.0)
    want = np.trunc(v).astype(np.uint8).reshape(frame.shape)
    got = pk.pcg_normal_noise_ref(torch.from_numpy(frame), state, inc, noise,
                                  shot)
    assert np.array_equal(got.numpy(), want)


def test_plain_version_refuses_what_the_kernel_refuses():
    f = torch.zeros((4, 4, 3), dtype=torch.uint8)
    with pytest.raises(TypeError, match="uint8"):
        pk.pcg_normal_noise_ref(f.float(), 1, 3, 3.0)
    with pytest.raises(ValueError, match="both zero"):
        pk.pcg_normal_noise_ref(f, 1, 3, 0.0, 0.0)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pk.pcg_normal_noise(f, 1, 3, 3.0)


# -- the committed tables ----------------------------------------------------

def test_header_tables_are_the_installed_numpys():
    """The header's ziggurat tables against the installed numpy's static
    library, read by symbol as tools/make_ziggurat_tables.py reads them."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "tools" / \
        "make_ziggurat_tables.py"
    spec = importlib.util.spec_from_file_location("_zig_tool", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    ki, wi, fi = tool.read_tables(tool.numpy_library())
    assert TABLES["ki"] == list(ki) and TABLES["fi"] == list(fi)
    assert TABLES["wi"] == list(wi)
    assert TABLES["ki"][1] == 0 and TABLES["r"] == 3.6541528853610087


def _advance(state: int, inc: int, k: int) -> int:
    for i in range(64):
        if k >> i & 1:
            state = (TABLES["jump_a"][i] * state
                     + TABLES["jump_p"][i] * inc) & MASK128
    return state


def test_jump_table_is_pcg64_advance():
    """The header's jump-ahead constants take (state, inc) k words on as
    numpy's PCG64.advance does, at run starts of both frame sizes."""
    _, state, inc = _state(11)
    for k in (0, 1, 31, 32, 33, 64 * 32 + 3, 2_764_800, 6_220_800,
              (1 << 40) + 7):
        bg = np.random.PCG64()
        bg.state = {"bit_generator": "PCG64",
                    "state": {"state": state, "inc": inc},
                    "has_uint32": 0, "uinteger": 0}
        bg.advance(k)
        assert bg.state["state"]["state"] == _advance(state, inc, k), k
    s = state
    for _ in range(5):                       # one word is one LCG step
        s = (s * MULT + inc) & MASK128
    assert _advance(state, inc, 5) == s


# -- a model of the kernel's decomposition -----------------------------------

def _dbl(word: int) -> float:
    return (word >> 11) * (1.0 / 9007199254740992.0)


def _attempt(raw, q: int):
    """(words taken, gave a normal, the normal) of the attempt whose first
    word is raw[q]: the kernel's ``attempt``."""
    ki, wi, fi = TABLES["ki"], TABLES["wi"], TABLES["fi"]
    w = int(raw[q])
    idx = w & 0xFF
    w >>= 8
    rabs = (w >> 1) & 0x000FFFFFFFFFFFFF
    x = rabs * wi[idx]
    if w & 1:
        x = -x
    if rabs < ki[idx]:
        return 1, True, x
    if idx == 0:
        used = 1
        while True:
            xx = -TABLES["inv_r"] * math.log1p(-_dbl(int(raw[q + used])))
            yy = -math.log1p(-_dbl(int(raw[q + used + 1])))
            used += 2
            if yy + yy > xx * xx:
                t = TABLES["r"] + xx
                return used, True, -t if (rabs >> 8) & 1 else t
    u = _dbl(int(raw[q + 1]))
    return 2, (fi[idx - 1] - fi[idx]) * u + fi[idx] < math.exp(
        -0.5 * x * x), x


ESC = (-1, 0)        # an entry the tables cannot say


class _Blocked(Exception):
    """A look-back that would spin on a tile that has not published yet."""


def decomposed(raw, n: int, run: int, depth: int, threads: int,
               lanes: int = 32, look: int = 4, resident: int = 6,
               order: int = 0):
    """The kernel's single pass over the words ``raw``: tiles of ``threads``
    runs of ``run`` words, taken in order, at most ``resident`` at once,
    looking back over ``lanes`` * ``look`` tiles a round,
    whose steps (tables and aggregate; look-back and inclusive; emit) a
    seeded scheduler interleaves, so tiles finish out of order and a
    look-back meets predecessors with an aggregate only. Returns (n
    normals, counts of the events that make the pass hard)."""
    ev = dict(far_run_entries=0, far_tile_entries=0, resolves=0,
              rewalks=0, past_tile=0, agg_only=0, waits=0, slides=0,
              fallbacks=0, wedge_rejects_across=0, tails_across=0)
    tw = run * threads
    words = n + n // 32 + 4096
    tiles = -(-words // tw)

    def attempt(t, i):
        """The attempt at word i of tile t: its buffer, then the generator
        past the buffer's end."""
        used, e, z = _attempt(raw, t * tw + i)
        ev["past_tile"] += i + used > tw
        return used, e, z

    def compose(g, f):
        out = []
        for a in g:
            b = ESC if a == ESC or a[0] >= depth else f[a[0]]
            out.append(ESC if b == ESC else (b[0], a[1] + b[1]))
        return out

    def walk_run(t, r, o):
        """The chain entering run r of tile t at o, from the words."""
        if o >= run:
            return o - run, 0
        ev["rewalks"] += 1
        c = 0
        while o < run:
            used, e, _ = attempt(t, r * run + o)
            o, c = o + used, c + e
        return o - run, c

    status = [0] * tiles                    # 1 aggregate, 2 inclusive
    agg, inc = [None] * tiles, [None] * tiles
    out = np.full(n, np.nan)

    full = (1 << run) - 1

    def chain(t, r, m, o):
        """The chain entering run r at o from the run's masks (fast,
        wedge, gives a normal): fast words counted a stretch at a time, a
        tail's length from the words."""
        fast, wedge, emits = m
        c = 0
        while o < run:
            ahead = full & ~((1 << o) - 1)
            slow = ~fast & ahead & full
            s = (slow & -slow).bit_length() - 1 if slow else run
            c += bin(fast & ahead & ((1 << s) - 1)).count("1")
            if s == run:
                return 0, c
            c += emits >> s & 1
            o = s + 2 if wedge >> s & 1 else s + attempt(t, r * run + s)[0]
        return o - run, c

    def tables(t):
        """Each run's masks (a thread each, every attempt of its run
        evaluated once) and table, the warps' shuffle scans, the block's
        composition; publishes the aggregate."""
        tab, masks = [], []
        for r in range(threads):
            m = [0, 0, 0]
            for q in range(run):
                used, e, _ = attempt(t, r * run + q)
                m[0] |= (used == 1) << q
                m[1] |= (used == 2) << q
                m[2] |= e << q
            masks.append(m)
            tab.append([chain(t, r, m, d) for d in range(depth)])
        ident = [(d, 0) for d in range(depth)]
        pre, wagg = [], []
        for w0 in range(0, threads, lanes):
            f = [list(x) for x in tab[w0:w0 + lanes]]
            f = [[tuple(e) for e in x] for x in f]
            s = 1
            while s < len(f):                # Hillis-Steele, as shuffles
                f = [compose(f[i - s], f[i]) if i >= s else f[i]
                     for i in range(len(f))]
                s *= 2
            pre += [ident] + f[:-1]
            wagg.append(f[-1])
        prefix, acc = [], ident
        for w, w0 in enumerate(range(0, threads, lanes)):
            prefix += [compose(acc, p) for p in pre[w0:w0 + lanes]]
            acc = compose(acc, wagg[w])
        # Published as words of 8-bit exits: 255 where it cannot say.
        agg[t] = [ESC if e[0] > 254 else e for e in acc]
        status[t] = 1
        return tab, prefix, masks

    def look_back(t):
        """The tile's entry offset and first normal: windows of ``lanes``
        * ``look`` predecessors (tile -1 enters tile 0 at (0, 0)); a window
        whose
        tiles up to the nearest inclusive value all have an aggregate is
        composed and carries that value forward, a window of aggregates
        only is composed and the look-back goes on before it; where the
        composition cannot say, it starts again later, once the tile that
        could not say has published its inclusive value."""
        ident = [(d, 0) for d in range(depth)]
        r, top, window = ident, t - 1, lanes * look
        while True:
            seen = [(p, 2 if p < 0 else status[p])
                    for p in range(top, top - window, -1)]
            j = next((i for i, (_, st) in enumerate(seen) if st == 2),
                     window)
            if any(st == 0 for _, st in seen[:j]):
                ev["waits"] += 1
                raise _Blocked
            f = ident
            for p, st in reversed(seen[:j]):
                f = compose(f, agg[p])
                ev["agg_only"] += st == 1
            r = compose(f, r)
            if j < window:
                p0 = seen[j][0]
                e = (0, 0) if p0 < 0 else inc[p0]
                if p0 == t - 1:
                    return e                   # exact, even past DEPTH
                c = r[e[0]] if e[0] < depth else ESC
                if c != ESC:
                    return c[0], e[1] + c[1]
                ev["fallbacks"] += 1           # again, once more is known
                raise _Blocked
            ev["slides"] += 1
            top -= window

    def entries(t, tab, prefix, o, base):
        """Each run's entry and first normal through its prefix, or, where
        a prefix cannot say, the tile walked run by run from its entry;
        publishes the inclusive value."""
        ev["far_tile_entries"] += o >= depth
        ent = [p[o] if o < depth else ESC for p in prefix]
        tot = agg[t][o] if o < depth else ESC
        if ESC in ent or tot == ESC:
            ev["resolves"] += 1
            ent, oo, k = [], o, 0
            for r in range(threads):
                ent.append((oo, k))
                ev["far_run_entries"] += depth <= oo < run and r > 0
                x, c = tab[r][oo] if oo < depth else walk_run(t, r, oo)
                oo, k = x, k + c
            tot = (oo, k)
        inc[t], status[t] = (tot[0], base + tot[1]), 2
        return ent

    def emit(t, ent, base, masks):
        """Each run walked again from its entry, from its masks inside the
        run; the tile's normals staged and written as one span, a normal
        from past the tile's end (the last tile walking on) directly."""
        span = inc[t][1] - base
        staged = {}
        for r in range(threads):
            p, k = ent[r][0], base + ent[r][1]
            last = t == tiles - 1 and r == threads - 1
            fast, wedge, emits = masks[r]
            while (p < run or last) and k < n:
                used, e, z = attempt(t, r * run + p)
                if p < run and (fast | wedge) >> p & 1:
                    used, e = 1 if fast >> p & 1 else 2, emits >> p & 1
                if p < run < p + used:
                    ev["wedge_rejects_across"] += used == 2 and not e
                    ev["tails_across"] += used >= 3
                if e:
                    if r * run + p < tw:
                        staged[k] = z
                    else:
                        out[k] = z
                    k += 1
                p += used
        lo, hi = base, min(base + span, n)
        assert sorted(staged) == list(range(lo, hi)), t
        out[lo:hi] = [staged[k] for k in range(lo, hi)]

    rng = np.random.default_rng(order)
    state = {}                               # tile -> its steps' results
    started, done = 0, 0
    while done < tiles:
        while started < tiles and len(state) < resident:
            state[started] = ["tables"]
            started += 1
        ready = []
        for t, st in state.items():
            if st[0] != "look":
                ready.append(t)
                continue
            try:
                st.append(look_back(t) if t else (0, 0))
                st[0] = "entries"
                ready.append(t)
            except _Blocked:
                pass
        assert ready, "deadlock"
        t = ready[rng.integers(len(ready))]
        st = state[t]
        if st[0] == "tables":
            st[:] = ["look", *tables(t)]
        elif st[0] == "entries":
            _, tab, prefix, masks, (o, base) = st
            st[:] = ["emit", entries(t, tab, prefix, o, base), base, masks]
        else:
            emit(t, *st[1:])
            del state[t]
            done += 1
    return out, ev


@pytest.mark.parametrize("run, depth, threads, lanes, look, resident, seed", [
    ("kernel", "kernel", "kernel", "kernel", "kernel", 6, 1),
    (3, 2, 64, 4, 1, 5, 2),
    (4, 1, 32, 8, 2, 3, 3),
    (5, 3, 96, 32, 4, 8, 4),
    (3, 1, 4, 2, 2, 9, 5),
])
def test_decomposition_model_is_numpys(run, depth, threads, lanes, look,
                                       resident, seed):
    """10⁵ normals through the model of the kernel's single pass, bitwise
    numpy's standard_normal from the same state: at the kernel's
    constants, and with runs of a few words, where wedge rejections and
    tail loops cross the runs' and tiles' edges, entries spill past the
    tables into runs and tiles and are walked again from the words, and
    the look-back passes predecessors with an aggregate only, waits on
    others and slides its window."""
    k = _kernel_constants()
    if run == "kernel":
        run, depth, threads, lanes, look = (k["RUN"], k["DEPTH"],
                                            k["THREADS"], k["LANES"],
                                            k["LOOK"])
    n = 100_000
    _, state, inc = _state(seed)
    bg = np.random.PCG64()
    bg.state = {"bit_generator": "PCG64",
                "state": {"state": state, "inc": inc},
                "has_uint32": 0, "uinteger": 0}
    raw = bg.random_raw(n + n // 16 + 8192)
    got, ev = decomposed(raw, n, run, depth, threads, lanes, look, resident,
                         seed)
    want = pk.generator(state, inc).standard_normal(n)
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64)), \
        int(np.flatnonzero(got != want)[0])
    assert ev["agg_only"] > 0 and ev["past_tile"] > 0, ev
    if run <= 5:
        assert ev["wedge_rejects_across"] > 10 and ev["tails_across"] > 5, ev
        assert ev["rewalks"] > 0 and ev["far_run_entries"] > 0, ev
        assert ev["resolves"] > 0 and ev["waits"] > 0, ev
    if threads <= 4:
        assert ev["far_tile_entries"] > 0 and ev["slides"] > 0, ev
        assert ev["fallbacks"] > 0, ev


# -- the renderer ------------------------------------------------------------

LABELS = np.zeros((19, 19), np.int8)
LABELS.flat[::7] = 1
LABELS.flat[3::11] = 2
HW = (120, 200)


@pytest.mark.parametrize("kw", [dict(), dict(shot_noise=0.4, glare=0.5,
                                             stone_jitter=0.07, clutter=2)])
def test_render_frame_draws_from_the_references_state(kw, monkeypatch):
    """The generator state the port hands to the noise is the reference's
    just before its draw: replay the reference's ``render_canonical`` and
    table draw on ``default_rng(seed)``."""
    seen = []

    def record(frame, state, inc, noise, shot_noise=0.0):
        seen.append((state, inc, noise, shot_noise))
        return frame

    monkeypatch.setattr(pk, "sensor_noise", record)
    synth.render_frame(LABELS, frame_hw=HW, seed=8, device="cpu", **kw)
    rng = np.random.default_rng(8)
    jsynth.render_canonical(LABELS, zone=24, rng=rng,
                            stone_jitter=kw.get("stone_jitter", 0.0),
                            jitter_key=8, glare=kw.get("glare", 0.0))
    rng.integers(-6, 6, (*HW, 1))
    st = rng.bit_generator.state["state"]
    assert seen == [(st["state"], st["inc"], 3.0,
                     kw.get("shot_noise", 0.0))]

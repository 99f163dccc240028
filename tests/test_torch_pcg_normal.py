"""The renderer's sensor noise (``ops/cuda/pcg_normal_kernel.py`` and
``csrc/pcg_normal.cu``) on the CPU: the plain version is numpy's draw,
bit for bit, with and without shot noise; the kernel's float32 expression
written out op by op is numpy's; the committed tables are numpy's; and a
Python model of the kernel's decomposition (runs of words, each run's
table, a warp's composition of its runs' tables, the scan over warps in
chunks and groups, each run's entry through its warp's prefix, the walk
again from the true entry) gives numpy's normals bit for bit, at the
kernel's own constants and at runs of a few words, where wedge rejections
and tail loops cross the runs' edges and entries spill past the tables."""

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
            for k in ("RUN", "DEPTH", "SCAN_THREADS", "LANES")}


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


ESC = -1


def decomposed(raw, n: int, run: int, depth: int, threads: int,
               lanes: int = 32):
    """The kernel's three passes over the words ``raw``: returns (n
    normals, counts of the events that make the scan hard)."""
    ev = dict(rewalks=0, wedge_rejects_across=0, tails_across=0,
              far_entries=0, escapes=0)
    runs = -(-(n + n // 32 + 4096) // run)
    warps = -(-runs // lanes)

    def pick(row, o):
        return row[o] if 0 <= o < depth else (ESC, 0)

    def compose(g, f):
        out = []
        for a in g:
            b = pick(f, a[0]) if a[0] >= 0 else (ESC, 0)
            out.append(b if b[0] < 0 else (b[0], a[1] + b[1]))
        return out

    # Pass 1: each run's attempts and its chains from the first entries,
    # then each warp's inclusive composition: every run's prefix and the
    # warp's table.
    table, prefix, wtab = [], [], []
    for w in range(warps):
        fs = []
        for r in range(w * lanes, (w + 1) * lanes):
            if r >= runs:
                fs.append([(ESC, 0)] * depth)
                continue
            steps = [_attempt(raw, r * run + q)[:2] for q in range(run)]
            row = []
            for d in range(depth):
                p, c = d, 0
                while p < run:
                    c += steps[p][1]
                    p += steps[p][0]
                row.append((p - run, c))
            table.append(row)
            fs.append(row)
        acc = [(d, 0) for d in range(depth)]
        for r, f in zip(range(w * lanes, (w + 1) * lanes), fs):
            if r < runs:
                prefix.append(acc)
            acc = compose(acc, f)
        wtab.append(acc)

    def rewalk(r, o):
        ev["rewalks"] += 1
        p, c = o, 0
        while p < run:
            k, e, _ = _attempt(raw, r * run + p)
            p, c = p + k, c + e
        return p - run, c

    def run_step(r, o):
        if o < depth:
            return table[r][o]
        return (o - run, 0) if o >= run else rewalk(r, o)

    def warp_step(w, o):
        e = pick(wtab[w], o)
        if e[0] >= 0:
            return e
        ev["escapes"] += 1
        total = 0
        for r in range(w * lanes, min((w + 1) * lanes, runs)):
            o, k = run_step(r, o)
            total += k
        return o, total

    # Pass 2: chunks of warps, groups of chunks, then every warp's entry.
    per = -(-warps // threads)

    def lo(c):
        return min(c * per, warps)

    def chunk_step(c, o):
        total = 0
        for w in range(lo(c), lo(c + 1)):
            o, k = warp_step(w, o)
            total += k
        return o, total

    ctab = []
    for c in range(threads):
        row = []
        for d in range(depth):
            o, total = d, 0
            for w in range(lo(c), lo(c + 1)):
                o, k = pick(wtab[w], o) if o >= 0 else (ESC, 0)
                total += k
            row.append((o if o < depth else ESC, total))
        ctab.append(row)

    def chunk_at(c, o):
        e = pick(ctab[c], o)
        return e if e[0] >= 0 else chunk_step(c, o)

    group = threads // lanes
    gt = []
    for g in range(lanes):
        row = []
        for d in range(depth):
            o, total = d, 0
            for c in range(g * group, (g + 1) * group):
                o, k = pick(ctab[c], o) if o >= 0 else (ESC, 0)
                total += k
            row.append((o, total))
        gt.append(row)
    o, base, gent = 0, 0, []
    for g in range(lanes):
        gent.append((o, base))
        e = pick(gt[g], o)
        if e[0] < 0:
            e = (o, 0)
            for c in range(g * group, (g + 1) * group):
                f = chunk_at(c, e[0])
                e = (f[0], e[1] + f[1])
        o, base = e[0], base + e[1]
    cent = []
    for g in range(lanes):
        o, base = gent[g]
        for c in range(g * group, (g + 1) * group):
            cent.append((o, base))
            o, k = chunk_at(c, o)
            base += k
    wentry = []
    for c in range(threads):
        o, base = cent[c]
        for w in range(lo(c), lo(c + 1)):
            wentry.append((o, base))
            o, k = warp_step(w, o)
            base += k
    # Pass 3: each run's entry through its warp's prefix; each run from its
    # true entry; the last walks on.
    out = np.full(n, np.nan)
    for r in range(runs):
        wo, wb = wentry[r // lanes]
        o, k = pick(prefix[r], wo)
        if o < 0:
            ev["escapes"] += 1
            o, k = wo, 0
            for q in range(r - r % lanes, r):
                o, c = run_step(q, o)
                k += c
        k += wb
        last = r == runs - 1
        ev["far_entries"] += depth <= o < run
        if k >= n or (o >= run and not last):
            continue
        p = o
        while (p < run or last) and k < n:
            used, e, z = _attempt(raw, r * run + p)
            if p + used > run and not last:
                ev["wedge_rejects_across"] += used == 2 and not e
                ev["tails_across"] += used >= 3
            p += used
            if e:
                out[k] = z
                k += 1
    return out, ev


@pytest.mark.parametrize("run, depth, threads, lanes, seed", [
    ("kernel", "kernel", "kernel", "kernel", 1),
    (3, 2, 64, 4, 2),
    (4, 1, 32, 8, 3),
    (5, 3, 96, 32, 4),
])
def test_decomposition_model_is_numpys(run, depth, threads, lanes, seed):
    """10⁵ normals through the model of the kernel's passes, bitwise
    numpy's standard_normal from the same state; with runs of a few words
    the wedge rejections and tail loops cross the runs' edges, and entries
    past the tables are walked again."""
    k = _kernel_constants()
    if run == "kernel":
        run, depth, threads, lanes = (k["RUN"], k["DEPTH"],
                                      k["SCAN_THREADS"], k["LANES"])
    n = 100_000
    _, state, inc = _state(seed)
    bg = np.random.PCG64()
    bg.state = {"bit_generator": "PCG64",
                "state": {"state": state, "inc": inc},
                "has_uint32": 0, "uinteger": 0}
    raw = bg.random_raw(n + n // 16 + 8192)
    got, ev = decomposed(raw, n, run, depth, threads, lanes)
    want = pk.generator(state, inc).standard_normal(n)
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64)), \
        int(np.flatnonzero(got != want)[0])
    if run <= 5:
        assert ev["wedge_rejects_across"] > 10 and ev["tails_across"] > 5, ev
        assert ev["rewalks"] > 0 and ev["far_entries"] > 0, ev
        assert ev["escapes"] > 0, ev


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

#!/usr/bin/env python3
"""Write the tables of numpy's normal sampler into the noise kernel's
header (``camkifu_tpu_torch/csrc/ziggurat_tables.cuh``).

    python3 tools/make_ziggurat_tables.py [--out PATH] [--check-only]

numpy's ``Generator.normal`` and ``standard_normal`` draw 64-bit words
from PCG64 and turn them into normals with a 256-layer ziggurat
(``random_standard_normal`` in numpy's ``distributions.c``). Its tables,
``ki_double``, ``wi_double`` and ``fi_double``, are static data of that
file: the tool reads them, by symbol, out of the object
``src_distributions_distributions.c.o`` in the installed numpy's
``numpy/random/lib/libnpyrandom.a`` (an ``ar`` archive of ELF objects,
parsed here in Python). The tail constants r and 1/r are numpy's own
literals, copied with all their digits.

Before it writes anything it checks the tables by behaviour: a pure-Python
model (PCG64's XSL-RR output, the ziggurat's fast path, wedge and tail)
must give ``Generator.normal`` and ``standard_normal`` bit for bit over
200,000 draws for several seeds, after a bounded-integer draw as the
renderer makes one, and end in numpy's generator state.

The header also holds PCG64's jump-ahead constants, from Python integers:
``A[i] = M^(2^i)`` and ``P[i] = M^0 + ... + M^(2^i - 1)`` modulo 2^128,
so that ``k`` steps from state ``s`` with increment ``inc`` are
``s -> A[i]·s + P[i]·inc`` for each set bit ``i`` of ``k`` (checked
against ``PCG64.advance``).

The build compiles only the committed header: run the tool again when
numpy's sampler changes.
"""

from __future__ import annotations

import argparse
import math
import os
import struct

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "camkifu_tpu_torch", "csrc", "ziggurat_tables.cuh")

MEMBER = "src_distributions_distributions.c.o"
SYMBOLS = ("ki_double", "wi_double", "fi_double")

#: numpy's ``ziggurat_nor_r`` and ``ziggurat_nor_inv_r``
#: (``numpy/random/src/distributions/ziggurat_constants.h``).
NOR_R = "3.6541528853610087963519472518"
NOR_INV_R = "0.27366123732975827203338247596"

MULT = 0x2360ED051FC65DA44385DF649FCCF645
MASK128 = (1 << 128) - 1
MASK64 = (1 << 64) - 1


# -- reading the tables --------------------------------------------------------

def ar_member(path: str, name: str) -> bytes:
    """The bytes of member ``name`` of a GNU ``ar`` archive."""
    data = open(path, "rb").read()
    if data[:8] != b"!<arch>\n":
        raise ValueError(f"{path} is not an ar archive")
    pos, longnames = 8, b""
    while pos + 60 <= len(data):
        head = data[pos:pos + 60]
        raw = head[:16].decode().rstrip()
        size = int(head[48:58].decode())
        body = data[pos + 60:pos + 60 + size]
        pos += 60 + size + (size & 1)
        if raw == "//":
            longnames = body
            continue
        if raw.startswith("/") and raw[1:].isdigit():
            off = int(raw[1:])
            raw = longnames[off:longnames.index(b"\n", off)].decode()
        if raw.rstrip("/") == name:
            return body
    raise KeyError(f"{name} not in {path}")


def elf_symbols(obj: bytes, names) -> dict[str, bytes]:
    """The contents of the named data symbols of a 64-bit little-endian
    ELF relocatable object, from its symbol table."""
    if obj[:4] != b"\x7fELF" or obj[4] != 2 or obj[5] != 1:
        raise ValueError("not a 64-bit little-endian ELF object")
    shoff, = struct.unpack_from("<Q", obj, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", obj, 0x3A)
    sections = [struct.unpack_from("<IIQQQQIIQQ", obj, shoff + i * shentsize)
                for i in range(shnum)]
    out = {}
    for sh in sections:
        if sh[1] != 2:                       # SHT_SYMTAB
            continue
        strtab = sections[sh[6]]
        for k in range(sh[5] // sh[9]):
            st_name, _, _, shndx, value, size = struct.unpack_from(
                "<IBBHQQ", obj, sh[4] + k * sh[9])
            start = strtab[4] + st_name
            sym = obj[start:obj.index(b"\0", start)].decode()
            if sym in names:
                base = sections[shndx][4] + value
                out[sym] = obj[base:base + size]
    missing = set(names) - set(out)
    if missing:
        raise KeyError(f"symbols not found: {sorted(missing)}")
    return out


def read_tables(lib: str):
    """(ki uint64[256], wi float64[256], fi float64[256]) from numpy's
    static library."""
    raw = elf_symbols(ar_member(lib, MEMBER), SYMBOLS)
    ki = struct.unpack("<256Q", raw["ki_double"])
    wi = struct.unpack("<256d", raw["wi_double"])
    fi = struct.unpack("<256d", raw["fi_double"])
    return ki, wi, fi


def numpy_library() -> str:
    return os.path.join(os.path.dirname(np.__file__), "random", "lib",
                        "libnpyrandom.a")


# -- the model -----------------------------------------------------------------

def pcg_next(state: int, inc: int) -> tuple[int, int]:
    """One PCG64 step: (new state, XSL-RR output of the new state)."""
    state = (state * MULT + inc) & MASK128
    hi, lo = state >> 64, state & MASK64
    rot = hi >> 58
    x = hi ^ lo
    return state, ((x >> rot) | (x << (64 - rot))) & MASK64


def standard_normal(ki, wi, fi, raws):
    """numpy's ``random_standard_normal`` over an iterator of raw 64-bit
    words: yields normals."""
    r, inv_r = float(NOR_R), float(NOR_INV_R)

    def dbl():
        return (next(raws) >> 11) * (1.0 / 9007199254740992.0)

    while True:
        for word in raws:
            idx = word & 0xFF
            word >>= 8
            sign = word & 1
            rabs = (word >> 1) & 0x000FFFFFFFFFFFFF
            x = rabs * wi[idx]
            if sign:
                x = -x
            if rabs < ki[idx]:
                yield x
                break
            if idx == 0:
                while True:
                    xx = -inv_r * math.log1p(-dbl())
                    yy = -math.log1p(-dbl())
                    if yy + yy > xx * xx:
                        yield -(r + xx) if (rabs >> 8) & 1 else r + xx
                        break
                break
            if (fi[idx - 1] - fi[idx]) * dbl() + fi[idx] < math.exp(
                    -0.5 * x * x):
                yield x
                break
        else:
            return


def check(ki, wi, fi, n: int = 200_000, seeds=(0, 7, 12345)) -> int:
    """Hold the model to numpy; return the number of tail draws seen."""
    tails = 0
    for seed in seeds:
        rng = np.random.default_rng(seed)
        rng.integers(-6, 6, (37, 11, 1))     # leaves a buffered 32-bit half
        st = rng.bit_generator.state["state"]
        state, inc = st["state"], st["inc"]
        raws = np.random.PCG64()
        raws.state = {"bit_generator": "PCG64",
                      "state": {"state": state, "inc": inc},
                      "has_uint32": 0, "uinteger": 0}
        words = raws.random_raw(int(n * 1.05) + 4096)
        s = state
        for k in range(1000):                # the Python step is numpy's
            s, out = pcg_next(s, inc)
            assert out == int(words[k]), (seed, k)
        it = iter(int(w) for w in words)
        model = np.fromiter(standard_normal(ki, wi, fi, it), np.float64, n)
        used = int(n * 1.05) + 4096 - sum(1 for _ in it)
        for noise in (None, 3.0):
            g = np.random.Generator(np.random.PCG64())
            g.bit_generator.state = {"bit_generator": "PCG64",
                                     "state": {"state": state, "inc": inc},
                                     "has_uint32": 0, "uinteger": 0}
            want = (g.standard_normal(n) if noise is None
                    else g.normal(0, noise, n))
            got = model if noise is None else 0.0 + noise * model
            if not np.array_equal(got.view(np.uint64), want.view(np.uint64)):
                bad = int(np.flatnonzero(got != want)[0])
                raise AssertionError(f"seed {seed}, noise {noise}: draw "
                                     f"{bad} differs ({got[bad]!r} against "
                                     f"{want[bad]!r})")
            end = g.bit_generator.state["state"]["state"]
            assert end == advance(state, inc, used), (seed, "end state")
        tails += int(np.sum(np.abs(model) > float(NOR_R)))
        # The generator's own state after a draw is the model's.
    return tails


# -- jump-ahead ----------------------------------------------------------------

def jump_tables(bits: int = 64):
    """(A, P): A[i] = MULT^(2^i), P[i] = sum of MULT^j for j < 2^i."""
    a, p = [MULT], [1]
    for _ in range(bits - 1):
        p.append(p[-1] * (1 + a[-1]) & MASK128)
        a.append(a[-1] * a[-1] & MASK128)
    return a, p


def advance(state: int, inc: int, k: int) -> int:
    a, p = jump_tables()
    for i in range(64):
        if k >> i & 1:
            state = (a[i] * state + p[i] * inc) & MASK128
    return state


def check_jump() -> None:
    rng = np.random.default_rng(99)
    for k in (0, 1, 2, 3, 31, 32, 1000, 2_764_800, 6_220_800, 2 ** 40 + 5):
        st = rng.bit_generator.state["state"]
        bg = np.random.PCG64()
        bg.state = {"bit_generator": "PCG64", "state": dict(st),
                    "has_uint32": 0, "uinteger": 0}
        bg.advance(k)
        assert bg.state["state"]["state"] == advance(st["state"], st["inc"],
                                                     k), k


# -- the header ----------------------------------------------------------------

def _u64(v: int) -> str:
    return f"0x{v:016x}ull"


def _rows(items, per: int) -> str:
    return "\n".join("    " + ", ".join(items[i:i + per]) + ","
                     for i in range(0, len(items), per))


def header(ki, wi, fi) -> str:
    a, p = jump_tables()
    pairs = lambda vals: [f"{{{_u64(v >> 64)}, {_u64(v & MASK64)}}}"
                          for v in vals]
    return f"""\
// Generated by tools/make_ziggurat_tables.py: do not edit.
//
// numpy {np.__version__}'s ziggurat tables for random_standard_normal,
// read from its static library (ki_double, wi_double, fi_double), the tail
// constants r and 1/r as numpy writes them, and PCG64's jump-ahead
// constants: A[i] = M^(2^i) and P[i] = M^0 + ... + M^(2^i - 1) modulo
// 2^128, each as {{high 64 bits, low 64 bits}}, so that k steps take state
// s to A[i]*s + P[i]*inc for each set bit i of k.
#pragma once

#include <stdint.h>

namespace zig {{

constexpr double NOR_R = {NOR_R};
constexpr double NOR_INV_R = {NOR_INV_R};

constexpr uint64_t PCG_MULT_HI = {_u64(MULT >> 64)};
constexpr uint64_t PCG_MULT_LO = {_u64(MULT & MASK64)};

__device__ const uint64_t KI[256] = {{
{_rows([_u64(v) for v in ki], 3)}
}};

__device__ const double WI[256] = {{
{_rows([v.hex() for v in wi], 3)}
}};

__device__ const double FI[256] = {{
{_rows([v.hex() for v in fi], 3)}
}};

__constant__ uint64_t JUMP_A[64][2] = {{
{_rows(pairs(a), 1)}
}};

__constant__ uint64_t JUMP_P[64][2] = {{
{_rows(pairs(p), 1)}
}};

}}  // namespace zig
"""


def parse_header(text: str):
    """(ki, wi, fi) back from a header this tool wrote."""
    def block(name):
        body = text.split(f"{name}[256] = {{", 1)[1].split("};", 1)[0]
        return [t.strip() for t in body.replace("\n", " ").split(",")
                if t.strip()]
    ki = [int(t.rstrip("ul"), 16) for t in block("KI")]
    wi = [float.fromhex(t) for t in block("WI")]
    fi = [float.fromhex(t) for t in block("FI")]
    return ki, wi, fi


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--check-only", action="store_true",
                    help="check the tables, write nothing")
    args = ap.parse_args(argv)
    ki, wi, fi = read_tables(numpy_library())
    tails = check(ki, wi, fi)
    check_jump()
    text = header(ki, wi, fi)
    assert parse_header(text) == (list(ki), list(wi), list(fi))
    print(f"numpy {np.__version__}: tables hold Generator.normal and "
          f"standard_normal bit for bit ({tails} tail draws); jump-ahead "
          f"holds PCG64.advance")
    if not args.check_only:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {os.path.relpath(args.out, ROOT)}")


if __name__ == "__main__":
    main()

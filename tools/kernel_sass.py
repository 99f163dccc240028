"""What the compiler made of the port's CUDA kernels (cuobjdump -sass).

    python3 tools/kernel_sass.py [kernel-name-part ...]

Builds the kernels as the port does (``ops/cuda/_build.py``), prints what
``ptxas`` reported for each (registers, shared memory, spills), then for
each kernel in the library whose name holds one of the given parts (all
kernels with none): its instruction count, and for its longest loop (the
widest backward branch) the instruction count and the commonest opcodes.
A loop's count against the pixels or votes one trip covers says how many
instruction slots the kernel spends on each. Needs ``nvcc`` and ``cuobjdump``
(the CUDA toolkit); exits 1 without them.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_INSTR = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_]+)"
                    r"[A-Z0-9_.]*\s*(.*?);")
_TARGET = re.compile(r"\bBRA\b.*?0x([0-9a-f]+)")


def _functions(sass: str) -> dict[str, list[tuple[int, str, str]]]:
    """{kernel name: [(address, opcode, operands)]} of a SASS listing."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = []
        elif name and (m := _INSTR.match(line)):
            out[name].append((int(m.group(1), 16), m.group(2), line))
    return out


def _longest_loop(instrs):
    """The instructions between the widest backward branch and its target."""
    best = None
    for addr, op, line in instrs:
        m = _TARGET.search(line) if op == "BRA" else None
        if m and int(m.group(1), 16) < addr:
            span = (int(m.group(1), 16), addr)
            if best is None or span[1] - span[0] > best[1] - best[0]:
                best = span
    if best is None:
        return []
    return [i for i in instrs if best[0] <= i[0] <= best[1]]


def main() -> int:
    from camkifu_tpu_torch.ops.cuda import _build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("kernel_sass: cuobjdump not found", file=sys.stderr)
        return 1
    try:
        path, _, log = _build.build()
    except RuntimeError as exc:
        print(f"kernel_sass: {exc}", file=sys.stderr)
        return 1
    for line in log.splitlines():
        if any(key in line for key in ("registers", "spill", "Compiling")):
            print(f"ptxas: {line.strip()}")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    parts = sys.argv[1:]
    for name, instrs in _functions(sass).items():
        if parts and not any(p in name for p in parts):
            continue
        loop = _longest_loop(instrs)
        ops = collections.Counter(op for _, op, _ in loop)
        print(f"{name}: {len(instrs)} instructions; longest loop "
              f"{len(loop)}: " + ", ".join(f"{op} {n}" for op, n
                                           in ops.most_common(14)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

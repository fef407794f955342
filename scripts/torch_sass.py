"""Summarise the SASS of the PyTorch port's kernels: instructions per
function and per loop, by opcode (needs nvcc and cuobjdump, so the GPU
machine).

    python3 scripts/torch_sass.py [SOURCE ...]

SOURCE names a ``csrc/<SOURCE>.cu`` of the package found on the path
(default: every source of ``ops/_build.NVCC_FLAGS``); it is built as the
package builds it. For each function: its instruction count and its most
frequent opcodes; for each loop (a branch back to a lower address), its
address range, its static instruction count and its counts of float32
arithmetic (FADD, FMUL, FFMA), MUFU, SHFL, branches and calls. Counts are
static: a cold path inside a loop (a slow division, a large-argument
reduction) counts as if it ran.
"""

import collections
import os
import re
import subprocess
import sys

from gym_pybullet_drones_tpu_torch.ops import _build

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"\b(?:BRA|BRX|JMP)\b[^`;]*?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")
_KEEP = ("FADD", "FMUL", "FFMA", "MUFU", "SHFL", "FSEL", "FMNMX", "BRA", "CALL", "BSSY")


def functions(lib):
    """{function name: [(address, text)]} from ``cuobjdump -sass``, with
    branch targets resolved to addresses."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    funcs, name, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            name = m.group(1)
            funcs[name] = []
            labels[name] = {}
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.match(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[name][lab] = addr
            pending = []
            funcs[name].append((addr, m.group(2)))
    return funcs, labels


def opcode(text):
    words = text.split()
    word = words[1] if words[0].startswith("@") else words[0]
    return word.split(".")[0]


def loops(insns, labels):
    """(start, end) of each backward branch's range, innermost first."""
    found = set()
    for addr, text in insns:
        m = _TARGET.search(text)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is not None and target <= addr:
            found.add((target, addr))
    return sorted(found, key=lambda r: r[1] - r[0])


def main():
    names = sys.argv[1:] or list(_build.NVCC_FLAGS)
    for lib_name in names:
        lib = _build.build(lib_name)
        funcs, labels = functions(lib)
        print(f"== {lib_name} ({' '.join(_build.NVCC_FLAGS[lib_name])})")
        for name, insns in funcs.items():
            ops = collections.Counter(opcode(t) for _, t in insns)
            print(f"-- {name}: {len(insns)} instructions; "
                  + ", ".join(f"{k} {v}" for k, v in ops.most_common(14)))
            for lo, hi in loops(insns, labels[name]):
                body = [t for a, t in insns if lo <= a <= hi]
                c = collections.Counter(opcode(t) for t in body)
                print(f"   loop [{lo:#06x}, {hi:#06x}]: {len(body)} instructions; "
                      + ", ".join(f"{k} {c[k]}" for k in _KEEP if c[k]))


if __name__ == "__main__":
    main()

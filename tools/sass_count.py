"""Count the SASS instructions of a built CUDA library's kernels.

    python tools/sass_count.py LIB.so [NAME]

Runs ``cuobjdump -sass`` on the library and prints, for every kernel
whose mangled name contains NAME, its instruction count and each loop
(a backward branch and the instructions it jumps over) with its
instructions by class. A loop's count divided by the output pixels one
pass of it computes per thread is the kernel's issue cost per output
pixel; ``-Xptxas -v`` (kept beside the library by
``superresolution_aniso_mri_tpu_torch/ops/_build.py``) gives registers,
shared memory and spills. Needs ``cuobjdump`` from the CUDA toolkit.
"""
from __future__ import annotations

import collections
import os
import re
import subprocess
import sys
from typing import Dict, List

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_TARGET = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")

# opcode → class; anything else counts as "other"
_CLASSES = {
    "fp32": ("FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "FSET"),
    "division": ("MUFU", "FCHK"),
    "shared": ("LDS", "STS"),
    "global": ("LDG", "STG", "LD", "ST", "RED", "ATOM", "ATOMG"),
    "int/address": ("IADD3", "IMAD", "LEA", "ISETP", "SHF", "LOP3", "IABS",
                    "SEL", "MOV", "I2F", "F2I", "IMNMX", "PRMT", "S2R",
                    "S2UR", "ULDC", "UMOV", "LDC", "ULEA", "UIADD3", "UIMAD"),
    "control": ("BRA", "BAR", "EXIT", "CALL", "RET", "BSYNC", "BSSY",
                "WARPSYNC", "NOP", "SHFL", "VOTE", "YIELD"),
}
_CLASS_OF = {op: cls for cls, ops in _CLASSES.items() for op in ops}


def _opcode(text: str) -> str:
    toks = text.split()
    if toks and toks[0].startswith("@"):
        toks = toks[1:]
    return toks[0].split(".")[0] if toks else ""


def parse(sass: str) -> Dict[str, List[tuple]]:
    """{kernel name: [(address, opcode, text), ...]} from cuobjdump."""
    kernels: Dict[str, List[tuple]] = {}
    current = None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            current = kernels.setdefault(m.group(1), [])
            continue
        m = _LINE.search(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), _opcode(m.group(2)),
                            m.group(2)))
    return kernels


def loops(instrs: List[tuple]) -> List[dict]:
    """Every backward branch: the instructions from its target to it."""
    out = []
    for addr, op, text in instrs:
        m = _TARGET.search(text) if op == "BRA" else None
        if not m or int(m.group(1), 16) > addr:
            continue
        start = int(m.group(1), 16)
        body = [o for a, o, _ in instrs if start <= a <= addr]
        classes = collections.Counter(_CLASS_OF.get(o, "other")
                                      for o in body)
        out.append(dict(start=start, end=addr, count=len(body),
                        classes=dict(sorted(classes.items()))))
    return out


def report(lib: str, name: str = "") -> str:
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    lines = []
    for kernel, instrs in parse(sass).items():
        if name not in kernel:
            continue
        ops = collections.Counter(_CLASS_OF.get(o, "other")
                                  for _, o, _ in instrs)
        lines.append(f"{kernel}: {len(instrs)} instructions "
                     f"{dict(sorted(ops.items()))}")
        for lp in loops(instrs):
            lines.append(f"  loop {lp['start']:#06x}-{lp['end']:#06x}: "
                         f"{lp['count']} instructions {lp['classes']}")
    return "\n".join(lines)


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    print(report(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else ""))

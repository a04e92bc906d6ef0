#!/usr/bin/env python3
"""Where each CUDA kernel of the port touches local memory, from its SASS.

    python3 scripts/sass_local_memory.py [--match REGEX]

Builds the port's kernels (``cartpoleplusplus_tpu_torch/csrc``, as the
package does at first use), disassembles the library with ``cuobjdump
-sass`` and prints one JSON line per kernel whose mangled name matches
``--match`` (default: every kernel): its instruction count, its
local-memory instructions (``STL``/``LDL``: register spills and stack
arrays) and, for each of them, how many loops enclose it.  A loop is the
address range from the target of a backward branch to the branch; depth 0
means the access runs once per thread (a heuristic of the code's layout:
it reads branches, not the control-flow graph).  ptxas's ``-v`` counts
spill bytes; this says whether they sit on a hot path.  Needs the CUDA
toolkit's ``cuobjdump`` (on the machine with the card).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cartpoleplusplus_tpu_torch import kernels  # noqa: E402

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")


def functions(sass: str) -> dict[str, list[tuple[int, str, str]]]:
    """``cuobjdump -sass`` output → {mangled name: [(address, opcode, operands)]}."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and (m := _INSN.search(line)):
            out[name].append((int(m.group(1), 16), m.group(2), m.group(3)))
    return out


def local_accesses(insns: list[tuple[int, str, str]]) -> dict:
    """Instruction count, and each local-memory access with its loop depth.
    Code after the last ``EXIT`` is out of line (the fallbacks of divergent
    shuffles and votes); its jumps back into the body are not loops."""
    end = max((addr for addr, op, _ in insns if op == "EXIT"), default=0)
    loops = []
    for addr, op, args in insns:
        m = re.search(r"0x([0-9a-f]+)\s*$", args.strip()) if op.startswith("BRA") else None
        if m and int(m.group(1), 16) < addr <= end:
            loops.append((int(m.group(1), 16), addr))
    found = [{"address": hex(addr), "op": op,
              "loop_depth": sum(lo <= addr <= hi for lo, hi in loops)}
             for addr, op, _ in insns if op.split(".")[0] in ("STL", "LDL")]
    return {"instructions": len(insns), "loops": len(loops), "local": found,
            "local_in_loops": sum(1 for f in found if f["loop_depth"] > 0),
            "max_loop_depth_of_local": max((f["loop_depth"] for f in found), default=0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--match", default=".", help="regex on the mangled kernel names")
    args = ap.parse_args()
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("sass_local_memory: no cuobjdump", file=sys.stderr)
        return 1
    lib = kernels.build()["path"]
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    for name, insns in sorted(functions(sass).items()):
        if re.search(args.match, name):
            print(json.dumps({"kernel": name, **local_accesses(insns)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

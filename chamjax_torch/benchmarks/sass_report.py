"""Count the memory instructions of every kernel in the built CUDA
libraries, from ``cuobjdump -sass``: global loads (``LDG``, by width),
``cp.async`` copies (``LDGSTS``), bulk copies (``UBLKCP``, the TMA's
non-tensor form) and the mbarrier operations that complete them
(``SYNCS.*``), shared-memory loads and stores (``LDS``, ``STS``) and
global stores (``STG``).  It shows which loads a kernel kept: the staged
scans and the measurement variants must copy their code bytes with
``LDGSTS.128`` (or one ``UBLKCP``) instead of byte loads, and a sink must
keep the loads that feed it.  Run it again whenever a measurement body,
its sink or the staged body changes (``adc_scan_variants.cu``,
``adc_scan_stage.cuh``): the counts in the notes and in PERF.md are this
report's.

    python -m chamjax_torch.benchmarks.sass_report
    python -m chamjax_torch.benchmarks.sass_report --match adc_scan_tiles

prints one JSON line per kernel (library, demangled name, counts).  Builds
the libraries first where needed; needs the CUDA toolkit (``cuobjdump``).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
from typing import Dict, Iterator, List, Optional

from chamjax_torch.utils import cuda_lib

KINDS = ("LDG", "LDGSTS", "UBLKCP", "SYNCS", "LDS", "STS", "STG")
_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
# "/*0090*/   @!P0 LDG.E.U8 R2, desc[UR4][R2.64] ;"
_INSTR = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def _tool(name: str) -> Optional[str]:
    nvcc_dir = os.path.dirname(cuda_lib._nvcc())
    cand = os.path.join(nvcc_dir, name)
    return cand if os.path.exists(cand) else shutil.which(name)


def parse_sass(text: str) -> Dict[str, collections.Counter]:
    """{mangled kernel name: Counter of opcodes of the kinds in KINDS, by
    full opcode (e.g. ``LDG.E.U8``) and by kind}."""
    out: Dict[str, collections.Counter] = {}
    current = None
    for line in text.splitlines():
        f = _FUNCTION.match(line)
        if f:
            current = out.setdefault(f.group(1), collections.Counter())
            continue
        i = _INSTR.search(line)
        if current is None or not i:
            continue
        op = i.group(1)
        kind = op.split(".")[0]
        if kind in KINDS:
            current[op] += 1
            if op != kind:
                current[kind] += 1
    return out


# the two issue pipes of Hopper's integer instructions, 64 lanes an SM a
# clock each: the integer pipe (add, logic, shift and funnel shift,
# compare, select) and the FMA pipe's integer multiply-add
PIPES = {
    "alu": ("IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP",
            "SEL", "LEA", "IMNMX", "PRMT", "IABS", "PLOP3", "BMSK", "VIADD"),
    "imad": ("IMAD", "IMUL"),
}
_PIPE_OF = {op: pipe for pipe, ops in PIPES.items() for op in ops}


def pipe_counts(text: str) -> Dict[str, collections.Counter]:
    """{mangled kernel name: Counter of its instructions by issue pipe
    (``PIPES``)}: static counts, each instruction once as written."""
    out: Dict[str, collections.Counter] = {}
    current = None
    for line in text.splitlines():
        f = _FUNCTION.match(line)
        if f:
            current = out.setdefault(f.group(1), collections.Counter())
            continue
        i = _INSTR.search(line)
        if current is not None and i:
            pipe = _PIPE_OF.get(i.group(1).split(".")[0])
            if pipe:
                current[pipe] += 1
    return out


def library_pipe_counts(lib: str) -> Dict[str, Dict[str, int]]:
    """{demangled kernel name: instructions by pipe} of built library
    ``lib`` (built first where needed)."""
    cuda_lib.build((lib,))
    cuobjdump = _tool("cuobjdump")
    if not cuobjdump:
        raise RuntimeError("cuobjdump not found beside nvcc or on PATH")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(cuda_lib.library_path(lib))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts = pipe_counts(sass)
    mangled = sorted(counts)
    return {name: dict(counts[raw])
            for raw, name in zip(mangled, _demangle(mangled))}


def _demangle(names: List[str]) -> List[str]:
    tool = _tool("cu++filt") or shutil.which("c++filt")
    if not tool or not names:
        return names
    res = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60)
    lines = res.stdout.splitlines()
    return lines if res.returncode == 0 and len(lines) == len(names) else names


def report(match: str = "") -> Iterator[Dict]:
    cuda_lib.build()
    cuobjdump = _tool("cuobjdump")
    if not cuobjdump:
        raise RuntimeError("cuobjdump not found beside nvcc or on PATH")
    for lib in cuda_lib.SOURCES:
        sass = subprocess.run([cuobjdump, "-sass",
                               str(cuda_lib.library_path(lib))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        counts = parse_sass(sass)
        mangled = sorted(counts)
        for raw, name in zip(mangled, _demangle(mangled)):
            if match in name or match == lib:
                yield dict(library=lib, kernel=name,
                           counts=dict(sorted(counts[raw].items())))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--match", default="",
                    help="only kernels whose demangled name holds this, "
                         "or every kernel of the library of this name")
    args = ap.parse_args(argv)
    for row in report(args.match):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

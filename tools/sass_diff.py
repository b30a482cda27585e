#!/usr/bin/env python3
"""Whether a kernel compiles to the same machine code in two versions of a
CUDA source: both built for ``sm_90a`` with the package's nvcc flags (one
nvcc each, started together), disassembled with ``cuobjdump -sass``, and
the named kernel's instructions compared line by line, with addresses and
encodings dropped (branch targets stay: they move when the code does).

    python3 tools/sass_diff.py OLD.cu NEW.cu OLD_KERNEL NEW_KERNEL [--out DIR]

OLD_KERNEL and NEW_KERNEL are substrings of the mangled names (e.g.
``segment_levels_f64_kernelEPd`` for a plain function and
``segment_levels_f64_kernelILb0`` for a template's instantiation).
Prints the card's name and power limit, ptxas's registers and spills of
both kernels, each one's instruction count, the number of differing
lines, the first of them, and one JSON line; exits 1 when they differ.
Writes both disassemblies to DIR (default ``build/sass``).
"""

from __future__ import annotations

import argparse
import difflib
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def kernel_sass(sass: str, name: str) -> tuple[str, list]:
    """(the mangled name, its instructions) of the one kernel whose name
    holds ``name``."""
    code: dict = {}
    cur = None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            code[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if cur is not None and m:
            code[cur].append(m.group(1))
    hits = [k for k in code if name in k]
    if len(hits) != 1:
        raise SystemExit(f"{len(hits)} kernels match {name!r}: {list(code)}")
    return hits[0], code[hits[0]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("old_kernel")
    ap.add_argument("new_kernel")
    ap.add_argument("--out", default=str(ROOT / "build" / "sass"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kb
    nvcc = kb.find_nvcc()
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    flags = [f for f in kb.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                   "-fPIC")]
    procs = {tag: subprocess.Popen(
        [nvcc, *flags, "-cubin", "-o", str(out / f"{tag}.cubin"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for tag, src in (("old", args.old), ("new", args.new))}
    ptxas = {}
    for tag, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{tag}: nvcc failed:\n{log}")
        ptxas[tag] = kb.parse_ptxas(log)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi or "no card", flush=True)
    tool = pathlib.Path(nvcc).parent / "cuobjdump"
    found = {}
    for tag, want in (("old", args.old_kernel), ("new", args.new_kernel)):
        sass = subprocess.run([str(tool), "-sass", str(out / f"{tag}.cubin")],
                              capture_output=True, text=True,
                              timeout=300).stdout
        (out / f"{tag}.sass").write_text(sass)
        found[tag] = kernel_sass(sass, want)
        name, ins = found[tag]
        info = next((v for k, v in ptxas[tag].items() if want in k), None)
        print(f"{tag}: {name}: {len(ins)} instructions; ptxas {info}",
              flush=True)
    diff = [d for d in difflib.unified_diff(found["old"][1], found["new"][1],
                                            lineterm="", n=0)
            if d[:1] in "+-" and d[:3] not in ("+++", "---")]
    print(f"differing lines: {len(diff)}", flush=True)
    for d in diff[:40]:
        print(f"  {d}")
    print(json.dumps({"card": smi, "old": len(found["old"][1]),
                      "new": len(found["new"][1]), "differing": len(diff)}))
    return 1 if diff else 0


if __name__ == "__main__":
    sys.exit(main())

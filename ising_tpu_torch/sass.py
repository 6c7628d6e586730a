"""What a CUDA kernel compiled to: SASS instructions by pipe, by source
line and in the kernel's main loop.

    python3 -m ising_tpu_torch.sass SOURCE.cu --kernel dense_sweep_kernel \\
        [--group NAME=FILE:LO-HI[,FILE:LO-HI...] ...] [--sites ARGS=N ...]
        [--dump LISTING.txt]

Compiles SOURCE with the port's nvcc flags and -lineinfo into a cubin (in a
temporary directory), disassembles it with nvdisasm
--print-line-info-inline (or reads such a listing, --listing), and
prints for each instantiation of the kernels whose name holds --kernel the
instructions by pipe (ALU, FMA, memory, ...): in the whole function and in
its main loop (the longest innermost loop), and in each --group of source
lines (a line of an inlined function counts where it is written, so
counter_rng.cuh's lines are the generators'; a toolkit intrinsic counts
where the repo's source calls it, where the listing says so; lines in no
group count as "other"). --sites "0,10,4=16" divides the main loop's counts of the
instantiation with template arguments (0, 10, 4) by 16, the sites one pass
of its loop updates. Needs nvcc and nvdisasm (the card's machine).
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

# SASS opcodes by the pipe that executes them (Volta to Hopper SMs).
ALU_OPS = {"IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "PRMT", "P2R",
           "R2P", "PLOP3", "IABS", "IMNMX", "FSEL", "FSETP", "MOV", "FLO",
           "POPC", "BMSK", "SGXT"}
FMA_OPS = {"IMAD", "IMUL", "FFMA", "FMUL", "FADD", "IDP"}

# one instruction of cuobjdump or nvdisasm: address, predicate, opcode
INSTR = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*)")


def pipe_of(opcode: str) -> str:
    base = opcode.split(".")[0]
    if base in ("HMMA", "HGMMA", "IMMA", "IGMMA"):
        return "tensor"
    if base in ALU_OPS:
        return "alu"
    if base in FMA_OPS:
        return "fma"
    if base.startswith("U") or base in ("S2UR", "R2UR"):
        return "uniform"
    if base[:2] in ("LD", "ST") or base in ("RED", "ATOM", "ATOMG"):
        return "memory"
    return "control/other"


def main_loop(instrs):
    """(lo, hi) addresses of the longest innermost loop's body (a backward
    branch whose range holds no other), or None: instrs are (address,
    opcode, branch target or None, (file, line))."""
    loops = {(target, addr) for addr, op, target, _ in instrs
             if op.startswith("BRA") and target is not None and target <= addr}
    inner = [r for r in loops if not any(
        o != r and r[0] <= o[0] and o[1] <= r[1] for o in loops)]
    return max(inner, key=lambda r: r[1] - r[0], default=None)


def functions(listing: str):
    """{function name: [(address, opcode, branch target, (file, line))]}
    from nvdisasm --print-line-info (or cuobjdump -sass, without lines).
    A target is a hex address (cuobjdump) or a label (nvdisasm)."""
    raw, name, where, labels, pending = {}, None, ("", 0), {}, []
    chain_start = True
    for text in listing.splitlines():
        m = (re.search(r"\.text\.(\S+?)[,\s]", text + " ")
             if ".section" in text else None) or re.search(
                 r"Function : (\S+)", text)
        if m:
            name = m[1]
            raw.setdefault(name, [])
            continue
        m = re.search(r'## File "([^"]+)", line (\d+)', text)
        if m:
            # an inlined call's lines come innermost first, one a level:
            # keep the innermost in the repo's sources (a toolkit intrinsic
            # counts where the repo's source calls it)
            if chain_start or not where[0].endswith((".cu", ".cuh")):
                where = (Path(m[1]).name, int(m[2]))
            chain_start = False
            continue
        m = re.match(r"\s*(\.L\w+):", text)
        if m:
            pending.append(m[1])
            continue
        m = INSTR.match(text)
        if m and name:
            chain_start = True
            addr = int(m[1], 16)
            for label in pending:
                labels[label] = addr
            pending = []
            if m[2] != "NOP":
                raw[name].append((addr, m[2], m[3], where))
    out = {}
    for name, instrs in raw.items():
        out[name] = []
        for addr, op, operands, wh in instrs:
            target = None
            if op.startswith("BRA"):
                t = re.search(r"(\.L\w+)|0x([0-9a-f]+)", operands)
                if t:
                    target = labels.get(t[1]) if t[1] else int(t[2], 16)
            out[name].append((addr, op, target, wh))
    return out


# The port's kernels, by the stem of each kernel template's name.
KERNELS = ("bit1_sweep", "bit1_planes", "bit1_decode", "packed_sweep",
           "packed_fused", "dense_sweep", "mxu_sweep")


def kernel_key(name: str):
    """(kernel, template arguments) of a mangled kernel name, or None for
    another function. The kernel is read from its own length-prefixed name
    (18bit1_planes_kernelI...), not from the anonymous namespace's, which
    holds the source file's name (_GLOBAL__N__<hash>_14_bit1_planes_cu_...)."""
    for stem in KERNELS:
        ident = stem + "_kernel"
        m = re.search(rf"(\d+){ident}I((?:L[ib]\d+E)+)E", name)
        if m and m[1].endswith(str(len(ident))):
            return stem, tuple(int(a) for a in re.findall(r"L[ib](\d+)E", m[2]))
    return None


def template_args(name: str):
    """The integer template arguments of a mangled kernel name."""
    m = re.search(r"I((?:L[ib]\d+E)+)E", name)
    return tuple(int(a) for a in re.findall(r"L[ib](\d+)E", m[1])) if m else ()


def parse_groups(specs):
    """[(name, [(file, lo, hi)])] from NAME=FILE:LO-HI[,FILE:LO-HI...]."""
    groups = []
    for spec in specs:
        name, _, ranges = spec.partition("=")
        parts = []
        for r in ranges.split(","):
            f, _, span = r.rpartition(":")
            lo, _, hi = span.partition("-")
            parts.append((f, int(lo), int(hi or lo)))
        groups.append((name, parts))
    return groups


def group_of(where, groups) -> str:
    f, line = where
    for name, parts in groups:
        if any(f == pf and lo <= line <= hi for pf, lo, hi in parts):
            return name
    return "other"


def mix(instrs, groups):
    """{group: Counter(pipe -> instructions)}, "all" the sum."""
    by = collections.defaultdict(collections.Counter)
    for _, op, _, where in instrs:
        pipe = pipe_of(op)
        by["all"][pipe] += 1
        by[group_of(where, groups)][pipe] += 1
    return by


def compile_listing(source: Path) -> str:
    from .ops import kernel_lib
    nvcc = kernel_lib.find_nvcc()
    tool = shutil.which("nvdisasm") or str(Path(nvcc).parent / "nvdisasm")
    flags = [f for f in kernel_lib.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    flags = [f for f in flags if f not in ("-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as d:
        cubin = Path(d) / "k.cubin"
        subprocess.run([nvcc, *flags, "-lineinfo", "-cubin", "-o", str(cubin),
                        str(source)], check=True, capture_output=True,
                       text=True, timeout=kernel_lib.NVCC_TIMEOUT_S)
        return subprocess.run([tool, "--print-line-info-inline", str(cubin)],
                              check=True, capture_output=True, text=True,
                              timeout=120).stdout


def fmt(counter) -> str:
    return ", ".join(f"{p} {n:g}" for p, n in sorted(counter.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", type=Path)
    ap.add_argument("--kernel", required=True)
    ap.add_argument("--group", action="append", default=[])
    ap.add_argument("--sites", action="append", default=[])
    ap.add_argument("--dump", type=Path, help="also write the listing here")
    ap.add_argument("--listing", type=Path,
                    help="read this listing (a --dump) instead of compiling")
    a = ap.parse_args(argv)
    groups = parse_groups(a.group)
    sites = {tuple(int(x) for x in k.split(",")): int(v)
             for k, _, v in (s.partition("=") for s in a.sites)}
    listing = (a.listing.read_text() if a.listing
               else compile_listing(a.source))
    if a.dump:
        a.dump.write_text(listing)
    for name, instrs in sorted(functions(listing).items()):
        if a.kernel not in name:
            continue
        targs = template_args(name)
        print(f"[sass] {a.source.name} {a.kernel}{list(targs)}")
        loop = main_loop(instrs)
        body = [i for i in instrs if loop and loop[0] <= i[0] <= loop[1]]
        for what, part in (("function", instrs), ("main loop", body)):
            for g, c in sorted(mix(part, groups).items()):
                print(f"[sass]   {what} {g}: {fmt(c)}")
        n = sites.get(targs)
        if n and body:
            for g, c in sorted(mix(body, groups).items()):
                print(f"[sass]   per site ({n} a pass of the loop) {g}: "
                      + fmt({p: k / n for p, k in c.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

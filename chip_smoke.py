#!/usr/bin/env python3
"""Run the PyTorch/H100 port (ising_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printed as it ends:

  1. device    the card's name, count, torch/CUDA versions, power limit;
  2. build     nvcc builds csrc/*.cu into one C library (seconds, ptxas);
  3. kernel    bit1_sweep against its plain torch version, bit for bit,
               at the full 16384 width and a small shape, in every ported
               rng mode, at T > 0 and T = 0, both colors, several steps;
  4. golden    the port's Simulation on the card reproduces the JAX
               package's trajectories recorded in ising_tpu_torch/golden.py;
  5. main path the CLI's Simulation at 16384^2 (bench.py's shape), with the
               launch count of bit1_sweep read just before and after, and
               E/N checked;
  6. timing    at 16384^2, the main path's shape: the kernel against its
               plain version once more, bit for bit, for both colors; then
               both timed per color phase (CUDA events), beside the least
               time the card could take and the compiled code's pipe mix.

It ends with one JSON line of the kernels and then the result line
{"ok": true, "device": {...}}. Any failure exits non-zero without the
result line. Without a CUDA device, or outside the repository, it fails
before printing anything of the kind. It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import faulthandler
import json
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ising_tpu_torch import cli, golden
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.models import ising
from ising_tpu_torch.ops import bit1, kernel_lib
from ising_tpu_torch.rng import PORTED_MODES, parse_rng_mode

BUDGET_S = 300          # the whole script, build included
MAIN_SHAPE = 16384      # bench.py's flagship lattice, 16384^2
MAIN_WARMUP, MAIN_ITERS = 8, 64
COMPARE_SHAPES = ((512, 16384, 0), (64, 1024, (1 << 25) - 32))  # (Y, X, row0)
COMPARE_STEPS = 3
TIMED_LAUNCHES = 100
TIMED_REPEATS = 5       # kernel timings per mode: median and spread
PLAIN_LAUNCHES = 2
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# 32-bit integer operations an SM can issue per clock: 64 INT32 lanes plus
# the 64 lanes of the FMA pipe, which runs the integer multiply-add IMAD
# (H100 whitepaper); 4 schedulers x 32 lanes also cap issue at 128.
INT_OPS_PER_SM_CLOCK = 128
PIPE_LANES_PER_SM = 64      # each of the ALU and FMA pipes
H100_BOOST_MHZ = 1980.0     # data-sheet max SM clock, if nvidia-smi has none

T_START = time.perf_counter()


def say(msg: str):
    print(msg, flush=True)


def elapsed() -> float:
    return time.perf_counter() - T_START


def run(cmd, timeout=60) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=timeout).stdout.strip()


class Failed(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise Failed(msg)


def phase_device():
    if not torch.cuda.is_available():
        raise Failed("no CUDA device: torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    clock = run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                 "--format=csv,noheader,nounits"]).splitlines()[0]
    try:
        mhz = float(clock)
    except ValueError:
        mhz = H100_BOOST_MHZ
    say(f"[device] {name}, count {torch.cuda.device_count()}, "
        f"{props.multi_processor_count} SMs, max SM clock {clock} MHz "
        f"(bound uses {mhz:.0f}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    say(smi)
    return {"name": name, "smi": smi, "sms": props.multi_processor_count,
            "clock_hz": mhz * 1e6}


def ops_per_word(mode: str, greedy: bool) -> int:
    """32-bit integer operations that one word's update (32 spins) needs,
    counted from the algorithm, not from the compiled code, at the fewest
    instructions the card has for them: a three-input add (IADD3) or
    logic function (LOP3), a rotation (SHF), a 32x32 multiply giving both
    halves (IMAD.WIDE) and a compare each count one, and so does setting
    a compare's result as bit g. Per-launch scalars (keys, round
    constants, thresholds) cost nothing. Loads, stores and control flow
    are not counted."""
    family, rounds = parse_rng_mode(mode)
    if family == "philox":
        # a round: two wide multiplies and two three-input xors; a call:
        # the 64-bit counter (2); 8 calls of 4 draws per word
        calls, per_call = 8, 4 * rounds + 2
    else:
        # a round: add, rotate, xor; every 4th round a key injection into
        # x1 (the one into x0 folds into the next round's IADD3, except
        # after the last round); a call: the 64-bit counter plus key (2);
        # 16 calls of 2 draws per word
        calls = 16
        per_call = 3 * rounds + rounds // 4 + (rounds % 4 == 0) + 2
    accept = 32 * (3 if greedy else 2) * 2   # compare + set bit, per threshold
    # index and (y, j) 4; edge selects and rotations of the 4 neighbours
    # and the off-column choice 12; adder and class masks 13; flip mask
    # and the xor into dst 3; counter base 2
    common = 34
    return calls * per_call + accept + common


# SASS opcodes by the pipe that executes them (Volta to Hopper SMs).
ALU_OPS = {"IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "PRMT", "P2R",
           "R2P", "PLOP3", "IABS", "IMNMX", "FSEL", "FSETP", "MOV", "FLO",
           "POPC", "BMSK", "SGXT"}
FMA_OPS = {"IMAD", "IMUL", "FFMA", "FMUL", "FADD", "IDP"}


def pipe_of(opcode: str) -> str:
    base = opcode.split(".")[0]
    if base in ALU_OPS:
        return "alu"
    if base in FMA_OPS:
        return "fma"
    if base.startswith("U") or base in ("S2UR", "R2UR"):
        return "uniform"
    if base[:2] in ("LD", "ST") or base in ("RED", "ATOM", "ATOMG"):
        return "memory"
    return "control/other"


def sass_mix(lib_path: str):
    """{(family, rounds, greedy): Counter(pipe -> SASS instructions)} of
    each bit1 kernel instantiation, from cuobjdump. The kernel is fully
    unrolled and branch-free apart from its edge selects, so this is close
    to the instructions one thread (one word) issues. None without
    cuobjdump."""
    tool = shutil.which("cuobjdump") or str(
        Path(kernel_lib.find_nvcc()).parent / "cuobjdump")
    try:
        sass = run([tool, "-sass", lib_path], timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    mix, key = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*bit1_sweep_kernelILi(\d)ELi(\d+)ELb([01])E", line)
        if m:
            key = (int(m[1]), int(m[2]), bool(int(m[3])))
            mix[key] = collections.Counter()
        elif "Function :" in line:
            key = None
        elif key:
            op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if op and op[1] != "NOP":
                mix[key][pipe_of(op[1])] += 1
    return mix


def phase_build():
    t0 = time.perf_counter()
    lib, info = kernel_lib.load()
    say(f"[build] nvcc {info.seconds:.1f} s (cached: {info.cached}), "
        f"load {time.perf_counter() - t0:.1f} s total -> {info.path}")
    for line in info.ptxas:
        say(f"[build]   {line.strip()}")
    mix = sass_mix(info.path)
    for key, pipes in sorted((mix or {}).items()):
        say(f"[build] SASS (family, rounds, greedy) = {key}: "
            f"{sum(pipes.values())} instructions, {dict(pipes)}")
    return info, mix


def random_words(gen, shape, device):
    a = gen.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def phase_compare(dev):
    """Kernel vs plain on the same CUDA tensors; returns (cases, max err)."""
    gen = np.random.default_rng(2024)
    cases, max_err = 0, 0
    for Y, X, row0 in COMPARE_SHAPES:
        H, W1 = Y, X // 64
        for mode in PORTED_MODES:
            for temp in (1.5, 0.0):
                thr = ising.threshold_table(temp)
                b = random_words(gen, (H, W1), dev)
                w = random_words(gen, (H, W1), dev)
                seed = int(gen.integers(0, 1 << 62))
                for step in range(COMPARE_STEPS):
                    for color, (dst, src) in enumerate(((b, w), (w, b))):
                        kw = dict(color=color, seed=seed, rng_mode=mode,
                                  greedy=temp <= 0)
                        up, dn = src[-1:], src[:1]
                        ref = bit1.bit1_sweep_reference(
                            dst, src, up, dn, thr, row0, step, **kw)
                        bit1.bit1_sweep(dst, src, up, dn, thr, row0, step, **kw)
                        torch.cuda.synchronize()
                        err = int((dst.to(torch.int64) - ref.to(torch.int64))
                                  .abs().max())
                        max_err = max(max_err, err)
                        cases += 1
                        require(torch.equal(dst, ref),
                                f"kernel != plain: {Y}x{X} row0={row0} "
                                f"{mode} T={temp} step={step} color={color}")
        say(f"[kernel] {Y}x{X} row0={row0}: every mode, T in (1.5, 0), "
            f"both colors, {COMPARE_STEPS} steps equal to the plain version")
    return cases, max_err


def phase_golden():
    for (mode, temp), want in golden.GOLDEN.items():
        got = golden.port_trajectory(mode, temp, device="cuda")
        require(got == want, f"golden {mode} T={temp}: got {got}, want {want}")
        say(f"[golden] {golden.NROWS}x{golden.NCOLS} {mode} T={temp}: "
            f"up counts {got['up']} and crc32 {got['crc32']:08X} match the "
            "JAX package")


def phase_main_path(card):
    """The CLI's flags, parsed and turned into a Simulation as cli.main
    does, then its run loop, which prints the CLI's lines."""
    results = {}
    for mode in ("threefry13", "philox"):
        argv = ["--backend", "bit1", "-x", str(MAIN_SHAPE), "-y",
                str(MAIN_SHAPE), "-w", str(MAIN_WARMUP), "-n",
                str(MAIN_ITERS), "-p", "16", "-t", "1.5", "--rng", mode]
        args = cli.build_parser().parse_args(argv)
        require(cli.unported_flag(args) is None, f"unported flag in {argv}")
        sim = Simulation(cli.config_from_args(args))
        bit1.bit1_sweep.launches = 0
        result = sim.run()
        launches = bit1.bit1_sweep.launches
        want = 2 * (MAIN_WARMUP + MAIN_ITERS)
        require(result["steps"] == MAIN_ITERS,
                f"ran {result['steps']} of {MAIN_ITERS} steps")
        require(launches == want,
                f"bit1_sweep launched {launches} times, expected {want}")
        e_n = sim.energy()
        require(e_n < -1.5, f"E/N = {e_n} after the run (expected < -1.5)")
        results[mode] = {"launches": launches, "e_n": e_n,
                         "flips_ns": result["flips_ns"]}
        say(f"[main] {MAIN_SHAPE}^2 {mode}: bit1_sweep launches {launches} "
            f"(= 2 x {MAIN_WARMUP + MAIN_ITERS} steps), E/N {e_n:.6f}, "
            f"{result['flips_ns']:.2f} flips/ns on {card['smi']}")
        del sim
        torch.cuda.empty_cache()
    return results


def time_launches(fn, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_timing(card, mix):
    """Per color phase at 16384^2: kernel against plain (bit for bit),
    then the kernel's and the plain version's times, and the bound.
    Returns (timing per mode, compared cases, max abs err)."""
    dev = torch.device("cuda")
    gen = np.random.default_rng(7)
    H, W1 = MAIN_SHAPE, MAIN_SHAPE // 64
    planes = [random_words(gen, (H, W1), dev) for _ in range(2)]
    thr = ising.threshold_table(1.5)
    words = H * W1
    spins = words * 32
    rate = card["sms"] * INT_OPS_PER_SM_CLOCK * card["clock_hz"]
    pipe_rate = card["sms"] * PIPE_LANES_PER_SM * card["clock_hz"]
    out, cases, max_err = {}, 0, 0
    for mode in ("threefry13", "philox"):
        kw = dict(seed=golden.SEED, rng_mode=mode, greedy=False)

        def args(i):
            dst, src = planes[i % 2], planes[1 - i % 2]
            return (dst, src, src[-1:], src[:1], thr, 0, i), dict(
                color=i % 2, **kw)

        def kernel(i):
            a, k = args(i)
            bit1.bit1_sweep(*a, **k)

        def plain(i):
            a, k = args(i)
            bit1.bit1_sweep_reference(*a, **k)

        for i in range(2):   # black then white, at the main path's shape
            a, k = args(i)
            ref = bit1.bit1_sweep_reference(*a, **k)
            bit1.bit1_sweep(*a, **k)
            torch.cuda.synchronize()
            err = int((a[0].to(torch.int64) - ref.to(torch.int64)).abs().max())
            max_err = max(max_err, err)
            cases += 1
            require(torch.equal(a[0], ref),
                    f"kernel != plain at {H}x{MAIN_SHAPE} {mode} color={i}")
        say(f"[timing] {MAIN_SHAPE}^2 {mode}: kernel equal to the plain "
            "version for both colors")

        time_launches(kernel, 10)
        runs = sorted(time_launches(kernel, TIMED_LAUNCHES)
                      for _ in range(TIMED_REPEATS))
        ms = runs[len(runs) // 2]
        plain(0)
        plain_ms = time_launches(plain, PLAIN_LAUNCHES)
        nbytes = 3 * words * 4   # read dst and src, write dst
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops = ops_per_word(mode, greedy=False)
        ops_ms = ops * words / rate * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "operations" if ops_ms > bytes_ms else "bytes"
        family, rounds = parse_rng_mode(mode)
        pipes = dict((mix or {}).get(
            (0 if family == "philox" else 1, rounds, False), {}))
        pipe_ms = {p: pipes[p] * words / pipe_rate * 1e3
                   for p in ("alu", "fma") if p in pipes}
        out[mode] = {"ms": ms, "ms_runs": runs, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes_ms": bytes_ms, "ops_per_word": ops,
                     "ops_ms": ops_ms, "sass_per_word": pipes,
                     "pipe_ms": pipe_ms}
        say(f"[timing] {MAIN_SHAPE}^2 {mode}, one color phase: kernel "
            f"{ms:.4f} ms median of {TIMED_REPEATS} x {TIMED_LAUNCHES} "
            f"launches (range {runs[0]:.4f}-{runs[-1]:.4f}; "
            f"{spins / ms / 1e6:.1f} flips/ns), plain {plain_ms:.2f} ms; "
            f"bound {bound_ms:.4f} ms by {bound_by} (bytes {bytes_ms:.4f} "
            f"ms; {ops} integer ops/word -> {ops_ms:.4f} ms), "
            f"{bound_ms / ms:.1%} of bound; compiled code per word "
            f"{pipes}, at {PIPE_LANES_PER_SM} lanes/SM per pipe "
            + ", ".join(f"{p} {t:.4f} ms" for p, t in pipe_ms.items())
            + f", on {card['smi']}")
    return out, cases, max_err


def _on_alarm(signum, frame):
    raise Failed(f"time budget of {BUDGET_S} s exceeded")


def main() -> int:
    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(BUDGET_S)
    # Hard stop even if the main thread is stuck inside a CUDA call.
    faulthandler.dump_traceback_later(BUDGET_S + 30, exit=True)
    try:
        card = phase_device()
        dev = torch.device("cuda")
        info, mix = phase_build()
        say(f"[time] {elapsed():.1f} s")
        cases, max_err = phase_compare(dev)
        say(f"[kernel] {cases} kernel-vs-plain cases equal, max abs err "
            f"{max_err}  [time {elapsed():.1f} s]")
        phase_golden()
        say(f"[time] {elapsed():.1f} s")
        main_runs = phase_main_path(card)
        say(f"[time] {elapsed():.1f} s")
        timing, full_cases, full_err = phase_timing(card, mix)
        cases, max_err = cases + full_cases, max(max_err, full_err)
        say(f"[kernel] {cases} kernel-vs-plain cases equal in all, max abs "
            f"err {max_err}  [time {elapsed():.1f} s]")
    except Failed as e:
        say(f"FAILED: {e}")
        return 1
    finally:
        signal.alarm(0)
        faulthandler.cancel_dump_traceback_later()
    t = timing["threefry13"]
    kernels = {"kernels": [{
        "name": "bit1_sweep",
        "route": "cuda",
        "source": "ising_tpu_torch/csrc/bit1_sweep.cu",
        "replaces": "ising_tpu/ops/pallas_bit1.py:265",
        "launches": main_runs["threefry13"]["launches"],
        "max_abs_err": max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "held_against_plain": True,
        "build_s": info.seconds,
        "per_mode": timing,
    }]}
    say(card["smi"])
    say(json.dumps(kernels))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

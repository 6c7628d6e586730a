#!/usr/bin/env python3
"""Run the PyTorch/H100 port (ising_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py [--against OLD_TREE]
    python3 chip_smoke.py --turns OTHER_TREE MODE[,PATH][,h=F][,T=0] ...
    python3 chip_smoke.py --gpus

Phases, each printed as it ends:

  1. device    the card's name, count, torch/CUDA versions, power limit;
  2. build     nvcc builds csrc/*.cu into one C library (seconds, ptxas:
               no kernel may have a stack frame; SASS: the mxu kernel must
               hold a tensor-core instruction, IMMA for its u8 products);
  3. kernel    bit1_sweep against its plain torch version, bit for bit,
               at the full 16384 width and two small shapes (one whose
               counters carry and whose rows wrap), then at heights that
               cross the row walk's bands (13, 21 and 48 rows) and a lone
               row at the 16384 width and at 2112 columns (W1 = 33), row0
               near 2^32 among them, in every rng mode, at
               T > 0, at T = 0 and, in the bit-plane modes and hw, with an
               external field; both colors, several steps; then on the
               disorder and replica paths (J planes, the split link store,
               replicas with csl == 1, csl == W1, ysl == 8 and ysl == H,
               replicas with J planes, and at 48 rows replicas of 6 and 12
               rows), in every mode and accept; then
               packed_sweep the same way on random words (bit 31 set in
               half of them), at the 16384 width and at 1056 (W = 66, not
               a multiple of 32), at heights that cross its bands (13, 21
               and 48 rows, 48 also in replicas of 6 and 12 rows) and a
               lone row, in the u32 modes and hw, at T > 0, T = 0 and with
               the full field table (h = 0.3, not hw), on the ordered,
               J-word, replica and replica + J paths; then the
               fused step, packed_fused_step and packed_fused_step_manual,
               against the plain fused step and two packed_sweep launches,
               both planes, at the 16384 width (384 rows) and at 1056
               columns with H = 14, 6 and 2 (bands of 1 and 3 rows, bands
               that wrap onto themselves), row0 0 and near 2^32, in the
               u32 modes and hw at T > 0, T = 0 and h = 0.3 (not hw); then
               dense_sweep on random bit planes at 16384^2 and at 1056
               columns (H = 14 and 7, counters that carry, rows that wrap)
               in the u32 modes and hw, at T > 0, T = 0, h = 0.3 (not hw)
               and with J planes; mxu_sweep at 16384^2, 128 x 256 and
               256 x 768 at T > 0 and T = 0; then the cluster labeler's
               three kernels: tile_roots against tile_roots_reference
               (positions, and ids where tiles hold whole replicas),
               hook_roots and flatten_roots together against the plain
               hook and flatten, and whole labelings (3 launches, or 1)
               against label_clusters, at 4096^2, 1024^2 and 200 x 328
               (tiles that do not divide it), in replicas of 128^2, 16^2
               and 32 x 64 (whole in a tile) and of 512 x 256 (cut by the
               tiles), with bonds open at p = 0, 0.585 and 1, and on the
               full lattices a cluster that snakes through every tile;
  4. golden    the port's Simulation on the card reproduces the JAX
               package's trajectories recorded in ising_tpu_torch/golden.py,
               the disordered ones with their energy, on every backend of
               the port that runs each case (golden.backends), and the
               Swendsen-Wang ones (golden.SW_GOLDEN);
  5. main path the CLI's Simulation at 16384^2 (bench.py's shape) in
               threefry13, philox and chacha6b, three runs each; with -J 0.1
               (the split link store) in threefry13 and chacha6b, three runs
               each, timing its set-up and peak memory; with --xsl 128
               --ysl 128 in chacha6b, three runs; with both in threefry13,
               one run. Each run reads the launch count of bit1_sweep just
               before and after and checks E/N. Then the CLI's default
               backend, xla (plain torch), at its default 2048^2, also with
               -J 0.1 --xsl 64 --ysl 64, whose lattice and energy must equal
               bit1's at the same flags. Then the packed backend through
               the same CLI at 16384^2: three runs each in threefry13,
               philox, chacha8 and hw, with -J 0.1 and with --xsl 128
               --ysl 128 in threefry13, one run with both, each reading
               packed_sweep's launch count; the same CLI under
               ISING_TPU_FUSED=1 and =2, three runs each in threefry13,
               philox, chacha8 and hw, one with --field 0.1 and one with
               -t 0, each reading the fused kernel's count (one a step)
               and packed_sweep's (0), and -J 0.1 under =1, where the JAX
               rule takes the two-call path; at 2048^2 packed's lattice
               and energy against bit1's and xla's, in threefry13 and in
               chacha8 with -J 0.1 --xsl 64 --ysl 64, and under =1 and =2
               against the two-call path's and bit1's. Then dense and mxu
               through the CLI at 8192^2 (bench.py:49-50) and 16384^2 in
               threefry13, philox, chacha8 and hw, three runs each, and
               dense with -J 0.1 (its set-up and peak memory timed), each
               reading its kernel's launch count; at 2048^2 mxu's, dense's,
               bit1's and xla's lattices equal in threefry13 and philox,
               dense's and bit1's lattices and energy with -J 0.1, mxu's,
               dense's and packed's in hw. Then --algo sw, the README's
               command at 4096^2 and T = Tc (three runs), with --xsl 128
               --ysl 128 and with --field 0.1, and 4 updates at 16384^2,
               each reading the labeler's three launch counts (tile_roots
               once an update, hook_roots and flatten_roots once an update
               whose tiles cut the lattice; their sum the launches the
               run counted); at 256^2 the card's lattice and launches
               after 8 updates equal the CPU's, also in replicas that the
               tiles cut. Then the output files (phase_io): the CLI at
               16384^2 on bit1 in threefry13 with -o -c --checkpoint A,
               then --resume A --checkpoint B, against one straight run
               to the same step (B's checkpoint body, the final dumps, the
               dumps and -c lines of the shared iterations equal), each
               run's bit1_sweep launches counted; A resumed on packed and
               on dense to the files of bit1's continuation; on one state
               bit1's word-domain paths (pack_storage_rows,
               encode_packed_rows, corr_rows) equal to the decode paths;
               the IO goldens (golden.IO_GOLDEN); and the times of a -c
               measurement (bit1, dense), a save, a resume and a dump.
               Then parallel tempering (phase_pt): the README's --pt
               command (1024^2, -J 0.5, 4 rungs, 200 rounds) on xla, bit1
               and packed, whose per-rung, acceptance and round-trip lines
               must be equal, bit1_sweep's and packed_sweep's launches
               counted (4 rungs x 8 sweeps x 2 x 200 rounds); the PT golden
               (golden.PT_GOLDEN) on bit1, packed and dense; at
               bench_pt.py's ladder (16 rungs at 4096^2, packed) batched
               rounds against per-rung rounds, their H, up counts, accepts
               and replica_at equal, one rung's sweeps and both rounds
               timed; at 16384^2 on bit1 the Fourier partials and the
               overlap of two seeds on the words against the decode path,
               and the overlap on packed's words and across backends,
               each timed. Then row slabs (phase_multi, `[multi]`) on
               meshes of the one card repeated 2, 4 and 8 times:
               MULTICHIP_r05.json's eight cases at 16384^2 (bit1 in
               threefry13, philox and chacha6b over 2, 4 and 8 slabs;
               halo_overlap on packed over 4 and on bit1 over 8; -J 0.1
               on packed and on bit1's J-plane path; replicas of 128^2;
               chacha8b; the field; a checkpoint saved at 1 slab and
               resumed at 4; SW at 4096^2 and Tc over 4 slabs), dense
               (also -J 0.1) and mxu over slabs, and per-shard dumps at
               4096^2: each equal to one device's run, every count set to
               0 before the sharded run and read after (2 launches a slab
               a step, 6 with halo_overlap; the labeler's 3 a slab an
               update); then 64 steps of bit1 at 16384^2 timed at 1 slab,
               through the slab path with one slab, over 2, 4 and 8
               slabs and with halo_overlap. Then the example studies
               (phase_examples, `[examples]`): tc_sweep at full width on
               bit1 (16384 replicas of 64^2 and of 128^2, 7 temperatures,
               400 + 200 steps: 2 x 600 x 14 bit1_sweep launches on the
               replica path, every U4 finite and at most 2/3 + 0.01, the
               crossing and collapse lines; sweeps and measurements
               timed apart from outside the example), tc_sweep --algo sw
               on 1024 replicas (the labeler's launches those of its
               updates), its physics check (SW on 1024 replicas of 32^2
               and 64^2: a finite crossing within 1% of Tc), the seven
               examples on the card and with --device cpu at small sizes
               (equal lines, launches counted), giant_lattice at 65536^2
               (2^32 spins: 66 launches, its word-domain up count and
               bond sum equal to int64 sums over decoded row slabs), the
               CLI at 16384^2 with and without --profile (equal lines,
               bit1 kernel events in the trace) and a 16384^2 hex dump
               through the native codec against numpy (equal crc32 and
               lattices read back, writes and reads timed in turns);
  6. timing    at 16384^2, the main path's shape, in every rng mode, and
               with an external field in the bit-plane modes and hw, and on
               the J-plane, split-link, replica and replica + J paths in
               threefry13, philox, chacha6b and chacha8: the kernel against
               its plain version once more, bit for bit, for both colors;
               then both timed per color phase (CUDA events), beside the
               least time the card could take and the ALU and FMA
               instructions a word in the kernel's main loop (the pair of
               rows a thread walks); then packed_sweep in every u32 mode
               and hw, with the field in philox, and on the J-word, replica and replica + J
               paths in threefry13, philox and chacha8, beside bit1's time
               in the same mode and path and its ALU and FMA instructions a
               word; then both fused kernels per step in every u32 mode and
               hw, at their default band and at 64 rows, beside two
               packed_sweep launches a step, the plain step, the bound and
               their ALU and FMA instructions a word; then dense_sweep
               (ordered, with
               J planes, with the field in philox) and mxu_sweep in every
               u32 mode and hw at 16384^2 and 8192^2 the same way; then
               at 4096^2 and 16384^2, on bonds drawn at Tc from the main
               path's lattice, a labeling (ms, launches, against its 6 B a
               site bytes bound and the plain label_clusters), each of its
               kernels alone against its bytes bound and plain version,
               the depth of the hooked forest, and the other parts of an
               update (bonds, coins and flip, the ghost), and at 4096^2 the
               labeling by tile.

With --against OLD_TREE (another checkout of the repository, such as its
parent commit's), it then times bit1_sweep and packed_sweep (phase 6's
cases: every mode, the field and every path) and both fused kernels (the
four main modes) at 16384^2 from OLD_TREE's kernel library and from this
tree's, in turns (old, new, new, old) on the same words, their results
equal; and runs the CLI at 16384^2 from OLD_TREE and from this tree in
turns (cli_turns.py: old, new, new, old): bit1 in threefry13, chacha6b and
hw, and in threefry13 dense, packed, and packed under ISING_TPU_FUSED=1.

With --gpus, on a machine with two or more GPUs, it builds the kernels
and runs only row slabs over the machine's own GPUs, one slab a GPU, halo
rows copied between devices (main_gpus): the flagship, halo_overlap,
disorder, replica and field cases over 2, 4 and 8 GPUs (as many as it
has), the checkpoint, dump and SW cases over 4, the CLI's --devs N lines
against --devs 1's, and the step loop timed at 16384^2 and 32768^2 over
1 GPU and those counts; it prints no result line.

With --turns OTHER_TREE and cases, it only times bit1_sweep in those
cases from both trees' libraries in turns, as --against does, and prints
both libraries' build times: a probe of a kernel edit, with no result line.

It ends with one JSON line of the kernels and then the result line
{"ok": true, "device": {...}}. Any failure exits non-zero without the
result line. Without a CUDA device, or outside the repository, it fails
before printing anything of the kind. It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import faulthandler
import functools
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ising_tpu_torch import (SimConfig, cli, cli_turns, cluster, device_trace,
                             golden)
from ising_tpu_torch import observables, sass
from ising_tpu_torch.constants import MAX_CORR_LEN, TCRIT
from ising_tpu_torch.models import ising
from ising_tpu_torch.ops import bit1, dense, kernel_lib, mxu, packed
from ising_tpu_torch.parallel.mesh import gather_rows
from ising_tpu_torch.rng import PORTED_MODES, parse_rng_mode, plane_bits
from ising_tpu_torch.utils.profiling import StepTimer

BUDGET_S = 600          # the whole script, build included
AGAINST_S = 600         # more for --against: the old tree's build and runs
MAIN_SHAPE = 16384      # bench.py's flagship lattice, 16384^2
MAIN_WARMUP, MAIN_ITERS = 8, 64
MAIN_REPEATS = 3        # CLI runs per mode: median and range
MAIN_MODES = ("threefry13", "philox", "chacha6b")
# Main-path runs of the disorder and replica paths: (path, flags, mode,
# runs, E/N below). -J alone takes the split link store on one device.
J_FLAGS = ["-J", "0.1"]
REPLICA_FLAGS = ["--xsl", "128", "--ysl", "128"]   # 2048 replicas of 128^2
MAIN_PATHS = (("split_links", J_FLAGS, "threefry13", 3, -1.2),
              ("split_links", J_FLAGS, "chacha6b", 3, -1.2),
              ("replicas", REPLICA_FLAGS, "chacha6b", 3, -1.5),
              ("replicas+jplanes", REPLICA_FLAGS + J_FLAGS, "threefry13", 1,
               -1.2))
XLA_SHAPE, XLA_ITERS = 2048, 8   # the CLI's default lattice
XLA_MODES = ("threefry13", "chacha6b")
# xla against bit1 with disorder and replicas: csl = 32 = W1 at 2048^2
XLA_GEOMETRY_FLAGS = ["-J", "0.1", "--xsl", "64", "--ysl", "64"]
# (Y, X, row0); the last wraps the global row mod 2^32 and carries every
# family's 64-bit counter into its high word
COMPARE_SHAPES = ((512, 16384, 0), (64, 1024, (1 << 25) - 32),
                  (64, 1024, (1 << 32) - 32))
# (Y, X, row0) of bit1's row walk: heights that cross its bands and do not
# divide them (13, 21 and 48 rows) and a lone row (both edge rows from src_up
# and src_dn), at the 16384 width and at 2112 columns (W1 = 33), counters
# that carry and rows that wrap mod 2^32 among them; one step, both colors.
# At 48 rows also on the disorder and replica paths, with replicas of 6 and
# 12 rows (which the bands do not divide).
BAND_SHAPES = ((13, 2112, (1 << 32) - 6), (21, 16384, 3), (48, 2112, (1 << 32) - 20),
               (1, 2112, 7), (13, 16384, 0), (21, 2112, (1 << 32) - 2),
               (48, 16384, (1 << 25) - 24), (1, 16384, (1 << 32) - 1))
# (temperature, field); a field only in the bit-plane modes and hw
ACCEPTS = ((1.5, 0.0), (0.0, 0.0), (1.5, 0.3))
TIMED_FIELD = 0.3
# Disorder and replica paths: (path, (csl, ysl) or None for the shape's own
# edge geometries); phase 3 runs each in every mode and accept.
GEOMETRY_PATHS = ("jplanes", "split_links", "replicas", "replicas+jplanes")
TIMED_PATH_MODES = ("threefry13", "philox", "chacha6b", "chacha8")
TIMED_CSL, TIMED_YSL = 64, 128    # --xsl 128 --ysl 128
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

# The packed backend: its u32 modes (and hw), its main-path runs (the
# README's `--backend packed --rng hw` at 16384^2, and its replica command
# --xsl 128 --ysl 128, whose csl = 64 divides W = 1024), the shapes of its
# kernel-vs-plain cases (W = 1024 and W = 66), its timed cases and the
# 2048^2 runs whose lattices must equal bit1's and xla's.
PACKED_MODES = tuple(m for m in PORTED_MODES if not plane_bits(m))
PACKED_MAIN_MODES = ("threefry13", "philox", "chacha8", "hw")
PACKED_MAIN_PATHS = (("jword", J_FLAGS, "threefry13", 3, -1.2),
                     ("replicas", REPLICA_FLAGS, "threefry13", 3, -1.5),
                     ("replicas+jword", REPLICA_FLAGS + J_FLAGS, "threefry13",
                      1, -1.2))
# (Y, X, row0): the 16384 width, W = 66 at counters that carry and rows that
# wrap mod 2^32, heights that cross the kernel's bands and do not divide
# them (13, 21 rows), a lone row (both edge rows from src_up and src_dn),
# and 48 rows, whose replicas of 6 and 12 rows the bands do not divide
PACKED_COMPARE_SHAPES = ((512, 16384, 0), (64, 1056, (1 << 25) - 32),
                         (48, 1056, (1 << 32) - 20), (13, 1056, (1 << 32) - 6),
                         (21, 16384, 3), (1, 1056, 7),
                         (64, 1056, (1 << 32) - 32))
PACKED_PATHS = ("jword", "replicas", "replicas+jword")
PACKED_TIMED_FIELD_MODES = ("philox",)
PACKED_TIMED_PATH_MODES = ("threefry13", "philox", "chacha8")
# the packed path's counterpart on bit1 (phase 6 times it there too)
BIT1_PATH_OF = {None: None, "jword": "jplanes", "replicas": "replicas",
                "replicas+jword": "replicas+jplanes"}
EQUALITY_SHAPE, EQUALITY_ITERS = 2048, 8
EQUALITY_RUNS = (("threefry13", []),
                 ("chacha8", ["-J", "0.1", "--xsl", "64", "--ysl", "64"]))

# The dense and mxu backends (uint8 planes, one u32 draw per site): their
# modes (packed's: the u32 modes and hw), the shapes of their
# kernel-vs-plain cases ((Y, X, row0): the main shape, and small shapes
# whose counters carry and whose rows wrap, C = 1056 and an odd H; mxu at
# its smallest lattice, 128 x 256, where ChaCha's runs are 8 columns), the
# CLI runs at bench.py's 8192^2 (bench.py:49-50) and the main 16384^2, and
# the 2048^2 runs whose lattices must equal the other backends'.
PLANE_MODES = PACKED_MODES
PLANE_MAIN_MODES = ("threefry13", "philox", "chacha8", "hw")
PLANE_MAIN_SHAPES = (8192, MAIN_SHAPE)
DENSE_COMPARE_SHAPES = ((MAIN_SHAPE, MAIN_SHAPE, 0), (14, 2112, (1 << 32) - 8),
                        (7, 2112, (1 << 29) - 4))
MXU_COMPARE_SHAPES = ((MAIN_SHAPE, MAIN_SHAPE, 0), (128, 256, (1 << 32) - 64),
                      (256, 768, (1 << 29) - 128))
PLANE_EQUALITY_RUNS = (("threefry13", [], ("mxu", "dense", "bit1", "xla")),
                       ("philox", [], ("mxu", "dense", "bit1", "xla")),
                       ("threefry13", J_FLAGS, ("dense", "bit1")),
                       ("hw", [], ("mxu", "dense", "packed")))
PLANE_TIMED_SHAPES = (MAIN_SHAPE, 8192)
# bytes a site moves: read dst and src, write dst (3); the J planes (7)
PLANE_PATH_BYTES = {None: 3, "jplanes": 7}
SWEEPS = {"bit1": bit1.bit1_sweep, "packed": packed.packed_sweep,
          "dense": dense.dense_sweep, "mxu": mxu.mxu_sweep}
# The fused packed step (kernel rows 3 and 4): one launch a step under
# ISING_TPU_FUSED=1 (packed_fused_step) and =2 (packed_fused_step_manual).
FUSED = {"1": packed.packed_fused_step, "2": packed.packed_fused_step_manual}
# Every launch counter: set to 0 before each main-path run.
COUNTERS = (*SWEEPS.values(), *FUSED.values(), *cluster.LABEL_PHASES)
# The wrapper that device_trace.step_launches names for a path.
STEP_WRAPPERS = {f.__name__: f for f in (*SWEEPS.values(), *FUSED.values())}
# Kernel-vs-plain shapes of the fused step, (Y, X, row0, band rows): W =
# 1024 at a few hundred rows; W = 66 (W/2 odd: ChaCha's pairs) with H = 14,
# 6 and 2, fewer rows than CTAs, bands of 1 and 3 rows and bands that wrap
# onto themselves; row0 0 and near 2^32 (counters that carry and wrap).
FUSED_COMPARE_SHAPES = ((384, 16384, 0, None), (384, 16384, (1 << 32) - 100, 1),
                        (14, 1056, (1 << 32) - 8, None), (14, 1056, 3, 3),
                        (6, 1056, 0, 1), (2, 1056, (1 << 32) - 1, None),
                        (2, 1056, 5, 1))
# =2 at four 16-row blocks of the goldens' 64 rows (=1 takes the JAX step's
# own block height: fusable there in Philox and ChaCha only)
FUSED_GOLDEN_BY = "16"
# Main-path runs under each variable: (what, flags, modes, runs, E/N below)
FUSED_MAIN_RUNS = (("ordered", [], PACKED_MAIN_MODES, MAIN_REPEATS, -1.5),
                   ("field", ["--field", "0.1"], ("threefry13",), 1, -1.5),
                   ("T = 0", ["-t", "0"], ("threefry13",), 1, -1.0))
FUSED_EQUALITY_MODES = ("threefry13", "philox")
FUSED_TIMED_BAND = 64   # a band height timed beside the default one
FUSED_KERNEL = {"1": "ising_tpu/ops/pallas_packed.py:453",
                "2": "ising_tpu/ops/pallas_packed.py:531"}

# Swendsen-Wang (--algo sw) and its cluster labeler (kernel row 7): the
# README's command at 4096^2 and T = Tc (README.md:62), three runs, then
# in replica mode and with the field, one run each; a few updates at
# 16384^2; at 256^2 the card's lattice against the CPU's. The labeler's
# kernel-vs-plain cases: (Y, X, ysl, xsl) with bonds open at LABEL_PROBS,
# a shape whose tiles do not divide it (200 x 328), the replica
# geometries 128 x 128 (one replica a tile), 16 x 16 and 32 x 64 (grouped
# in tiles) and 512 x 256 (cut by the tiles, its wraps hooked across).
SW_SHAPE, SW_ITERS, SW_PRINT = 4096, 64, 8
SW_FLAGS = ["--algo", "sw", "-a", "1.0"]
SW_RUNS = (("full lattice", [], 3), ("replicas", REPLICA_FLAGS, 1),
           ("field", ["--field", "0.1"], 1))
SW_SCALE_SHAPE, SW_SCALE_ITERS = 16384, 4
SW_EQUALITY_SHAPE, SW_EQUALITY_ITERS = 256, 8
LABEL_CASES = ((SW_SHAPE, SW_SHAPE, None, None), (1024, 1024, None, None),
               (200, 328, None, None), (SW_SHAPE, SW_SHAPE, 128, 128),
               (1024, 1024, 16, 16), (1024, 1024, 32, 64),
               (1024, 1024, 512, 256))
LABEL_PROBS = (0.0, 0.585, 1.0)
# A labeling reads the two bond planes and writes the labels: 6 B a site.
LABEL_BYTES_PER_SITE = 6

# The output files (dumps, -c files, the v2 checkpoint) at the main path's
# 16384^2 on bit1 in threefry13, a u32 counter mode, so that packed and
# dense continue the stream of a bit1 checkpoint. The first run's flags; the resumed run
# repeats the warmup (the JAX CLI's run loop does), so the straight run
# that ends at the same step takes IO_STRAIGHT_ITERS iterations.
IO_MODE = "threefry13"
IO_WARMUP, IO_ITERS, IO_PRINT = 8, 8, 8
IO_STRAIGHT_ITERS = IO_WARMUP + 2 * IO_ITERS
IO_FLAGS = ["--backend", "bit1", "-x", str(MAIN_SHAPE), "-y", str(MAIN_SHAPE),
            "-w", str(IO_WARMUP), "-p", str(IO_PRINT), "-t", "1.5", "--rng",
            IO_MODE, "-o", "-c"]
IO_RESUME_BACKENDS = ("packed", "dense")
# Parallel tempering (--pt, phase_pt): the README's command (README.md:63)
# on three backends, whose lines must be equal, bit1's and packed's
# sweeps counted (rungs x sweeps a swap x 2 x rounds); the PT golden on
# three backends; bench_pt.py's ladder (scripts/experiments/bench_pt.py:
# 16 rungs at 4096^2 on packed in threefry13, 4 sweeps a swap, a
# geometric ladder from 1.5 to 3.5) batched against per rung; and at
# 16384^2 on bit1 in threefry13 the Fourier partials and the overlap on
# the words against the decode path.
PT_FLAGS = ["-x", "1024", "-y", "1024", "-J", "0.5", "--pt",
            "0.8,1.0,1.3,1.7", "-n", "200", "-p", "50"]
PT_LAUNCHES = 4 * 8 * 2 * 200
PT_BACKENDS = ("xla", "bit1", "packed")
PT_GOLDEN_BACKENDS = ("bit1", "packed", "dense")
PT_BENCH_SIZE, PT_BENCH_RUNGS, PT_BENCH_SWEEPS = 4096, 16, 4
PT_BENCH_TEMPS = (1.5, 3.5)
PT_BENCH_SEED = 463463564571
PT_BENCH_ROUNDS = 5
PT_WORDS_MODE, PT_WORDS_STEPS = "threefry13", 4
# Row slabs on the one card (phase_multi): meshes of the card repeated;
# MULTICHIP_r05.json's cases at MAIN_SHAPE^2, each against one device:
# (name, backend, rng mode, config, slab counts). Then a checkpoint saved
# at 1 slab and resumed at 4, per-shard dumps at MULTI_DUMP_SHAPE^2, SW
# at SW_SHAPE^2 over 4 slabs, and the step loop timed by slab count.
MULTI_SLABS = (2, 4, 8)
MULTI_STEPS = 3
MULTI_CASES = (
    ("flagship", "bit1", "threefry13", {}, MULTI_SLABS),
    ("flagship", "bit1", "philox", {}, MULTI_SLABS),
    ("flagship", "bit1", "chacha6b", {}, MULTI_SLABS),
    ("halo_overlap", "packed", "threefry13", {"halo_overlap": True}, (4,)),
    ("halo_overlap", "bit1", "threefry13", {"halo_overlap": True}, (8,)),
    ("disorder", "packed", "philox", {"j_prob": 0.1}, (4,)),
    ("disorder", "bit1", "threefry13", {"j_prob": 0.1}, (4,)),
    ("replica", "bit1", "threefry13", {"xsl": 128, "ysl": 128}, (4,)),
    ("plane_rng", "bit1", "chacha8b", {}, (8,)),
    ("field", "bit1", "threefry13b", {"field": 0.7}, (4,)),
    ("dense", "dense", "threefry13", {}, (4,)),
    ("dense disorder", "dense", "philox", {"j_prob": 0.1}, (2,)),
    ("mxu", "mxu", "philox", {}, (4,)),
)
MULTI_DUMP_SHAPE = 4096
# --gpus (a machine with several GPUs, one slab a GPU): the cases run
# there, and the larger lattice its step loop is also timed at.
GPUS_CASES = tuple(c for c in MULTI_CASES
                   if c[:2] in (("flagship", "bit1"), ("halo_overlap",
                                                       "packed"),
                                ("disorder", "bit1"), ("replica", "bit1"),
                                ("field", "bit1"))
                   and c[2] in ("threefry13", "philox", "threefry13b"))
GPUS_TIMED_SHAPE = 32768
MULTI_SW_ITERS = 3
MULTI_TIMED_STEPS, MULTI_TIMED_REPEATS = 64, 3
LABEL_TILES = ((64, 128), (128, 128), (32, 128))
# The example studies (phase_examples, `[examples]`): the Binder Tc sweep
# at full width on bit1 (16384 replicas of 64^2 on 8192^2 and of 128^2 on
# 16384^2; the script's 7 temperatures, 400 + 200 steps, a measurement
# every 4), its Swendsen-Wang form on 1024 replicas and SW's physics
# check (EX_SW_TC_FLAGS below), the seven examples on
# the card and with --device cpu at small sizes (tests/test_examples.py's,
# tc_sweep on bit1 at the smallest replica geometry bit1 admits, hysteresis
# on bit1 at 64^2, the narrowest bit1 lattice), giant_lattice past 2^32
# spins, the CLI's --profile and the native codec's dump.
EX_TC_FLAGS = ["--backend", "bit1", "--sizes", "64,128", "--replicas",
               "16384"]
EX_TC_SIZES, EX_TC_REPLICAS_ACROSS = (64, 128), 128
EX_TC_TEMPS, EX_TC_STEPS, EX_TC_EVERY = 7, 400 + 200, 4
EX_SW_FLAGS = ["--algo", "sw", "--sizes", "64,128", "--replicas", "1024",
               "--ntemps", "3", "--warmup", "4", "--measure", "8", "--every",
               "2"]
EX_SW_UPDATES = (4 + 8) * 3 * 2
# The physics check: Swendsen-Wang decorrelates a replica in a few updates
# even at Tc, so 20 + 40 updates on 1024 replicas of 32^2 and of 64^2
# equilibrate where 400 Metropolis sweeps at L = 128 do not; the crossing
# of their Binder cumulants must be finite and within EX_SW_TC_TOL of Tc.
EX_SW_TC_FLAGS = ["--algo", "sw", "--sizes", "32,64", "--replicas", "1024",
                  "--ntemps", "5", "--warmup", "20", "--measure", "40",
                  "--every", "2"]
EX_SW_TC_TOL = 0.01
# (example, flags, the card run's launches by wrapper, or None: the
# labeler's, as its updates make them)
EX_SMALL = (
    ("tc_sweep", ["--backend", "bit1", "--sizes", "8,16", "--replicas",
                  "1024", "--warmup", "20", "--measure", "12", "--ntemps",
                  "3"], {"bit1_sweep": 2 * 32 * 3 * 2}),
    ("reweight_peak", ["--size", "16", "--ntemps", "3", "--warmup", "40",
                       "--samples", "40", "--every", "2"], {}),
    ("xi_scan", ["--sizes", "8,16", "--ntemps", "3", "--warmup", "5",
                 "--samples", "12"], None),
    ("cluster_vs_metropolis", ["--size", "16", "--warmup", "20",
                               "--samples", "64", "--sw-samples", "32"],
     None),
    ("spin_glass_pt", ["--size", "16", "--rungs", "3", "--rounds", "8",
                       "--sweeps", "2", "--realizations", "2"], {}),
    ("hysteresis", ["--size", "64", "--hmax", "1.0", "--steps", "5",
                    "--sweeps", "4", "--backend", "bit1"],
     {"bit1_sweep": 2 * (10 * 4 + 2 * 5 * 4)}),
    ("giant_lattice", ["--rows", "16", "--cols", "64", "--steps", "4"],
     {"bit1_sweep": 2 * 5}),
)
EX_GIANT_FLAGS = ["--rows", "65536", "--cols", "65536", "--steps", "32"]
EX_PROFILE_FLAGS = ["--backend", "bit1", "-x", str(MAIN_SHAPE), "-y",
                    str(MAIN_SHAPE), "-n", "16", "-p", "4", "-t", "1.5"]

LABEL_KERNEL = {"source": "ising_tpu_torch/csrc/cluster_label.cu",
                "replaces": "ising_tpu/cluster.py:168"}

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


def or_ops(m: int) -> int:
    """Three-input ORs (LOP3) that join m words into one."""
    return m // 2


def field_accept_ops(kbits: int, tvals10, always10: int) -> int:
    """Operations of the 10-class external-field accept on this run's
    table, under ops_per_word's rule: the n == v masks of the counts that
    a flipping class uses, one mask per such class (own bit & n == v),
    per plane the OR of the stochastic classes whose threshold has bit z
    set (T_z) and one three-input logic op for the strict less-than chain
    lt' = (T_z & ~u) | (~(T_z ^ u) & lt), then the OR of the always-classes
    into the flip. Classes that never flip (t = 0) cost nothing."""
    always = [c for c in range(10) if always10 >> c & 1]
    stoch = [c for c in range(10) if not always10 >> c & 1 and tvals10[c]]
    ops = len({c % 5 for c in always + stoch}) + len(always) + len(stoch)
    for z in range(kbits):
        ops += or_ops(sum(tvals10[c] >> z & 1 for c in stoch)) + 1
    return ops + or_ops(len(always) + 1)


def call_ops(family: str, rounds: int) -> tuple[int, int]:
    """(draws, operations) of one generator call under ops_per_word's rule,
    with the 64-bit counter's 2."""
    if family == "philox":
        # a round: two wide multiplies and two three-input xors; the first
        # round's multiply of counter word 2 (the step) is per-launch
        return 4, 4 * rounds - 1 + 2
    if family == "threefry":
        # a round: add, rotate, xor; every 4th round a key injection into
        # x1 (the one into x0 folds into the next round's IADD3, except
        # after the last round)
        return 2, 3 * rounds + rounds // 4 + (rounds % 4 == 0) + 2
    # a round: 4 quarter-rounds of 4 adds, 4 xors, 4 rotations; a block: 16
    # feed-forward adds. Only state words 12 and 13 (the counter) vary by
    # thread, so the first column round's quarter-rounds on columns 2 and 3
    # (24), the first add of columns 0 and 1 (2) and the first diagonal
    # round's first add on (x2, x7) (1) are per-launch: 27 per block
    return 16, 48 * rounds + 16 - 27 + 2


# What a disorder or replica path adds to a word's update, under
# ops_per_word's rule, and the words of lattice traffic it moves per word.
# A thread walks a band of rows down its word column, so what is fixed for
# a thread or a row (its side, its plane choice, a replica's edges, a row's
# address) is control and loads, not operations a word. J planes: 4 xors of
# the flags into the neighbours. Split links: the same 4 xors, and the
# rotation of the off-column link word at the row's first lane (1).
# Replicas: nothing (the row's replica edges pick the rows loaded, the
# column's pick the side word, and the lane wraps take no rotation).
# Traffic: read dst and src, write dst (3), and the four link words where
# there are links (7).
PATH_OPS = {None: 0, "jplanes": 4, "split_links": 5, "replicas": 0,
            "replicas+jplanes": 4}
PATH_WORDS = {None: 3, "jplanes": 7, "split_links": 7, "replicas": 3,
              "replicas+jplanes": 7}


def ops_per_word(mode: str, greedy: bool, field_table=None,
                 path: str | None = None) -> int:
    """32-bit integer operations that one word's update (32 spins) needs,
    counted from the algorithm, not from the compiled code, at the fewest
    instructions the card has for them: a three-input add (IADD3) or
    logic function (LOP3), a rotation (SHF), a 32x32 multiply giving both
    halves (IMAD.WIDE) and a compare each count one, and so does setting
    a compare's result as bit g. Per-launch scalars (keys, round
    constants, step, tag, thresholds) and whatever is computed from them
    alone cost nothing. Loads, stores and control flow are not counted.
    field_table: (tvals10, always10) of the external-field accept; path: a
    disorder or replica path (PATH_OPS)."""
    family, rounds = parse_rng_mode(mode)
    kbits = bit1.accept_bits(mode)
    if family == "hw":   # salted Philox-10
        family, rounds = "philox", 10
    draws, per_call = call_ops(family, rounds)
    if kbits:
        # k planes per word; per plane one three-input logic op for each
        # of the two thresholds (a' = t_z ? ~u | a : ~u & a)
        calls, accept = kbits // draws, 2 * kbits
    else:
        # 32 draws per word; compare + set bit, per threshold
        calls, accept = 32 // draws, 32 * (3 if greedy else 2) * 2
    # the bit-sliced adder 8; the off-column word's rotation 1; the xor
    # into dst 1; the row's counter base 2 (a thread's column and rows come
    # from its grid position, its side is fixed down its band)
    common = 8 + 1 + 1 + 2
    if field_table is not None:
        accept = field_accept_ops(kbits, *field_table)
    else:
        # the class masks ge3, ge4, eq2 (5) and the flip mask (2)
        accept += 5 + 2
    return calls * per_call + accept + common + PATH_OPS[path]


# The packed kernel's paths under ops_per_word's rule: the J word's four
# flags, each shifted (but the first) and masked into its neighbour with one
# three-input op (7); replicas as for bit1 (+2). Traffic per word: read dst
# and src, write dst (3), and the J word (4).
PACKED_PATH_OPS = {None: 0, "jword": 7, "replicas": 2, "replicas+jword": 9}
PACKED_PATH_WORDS = {None: 3, "jword": 4, "replicas": 3, "replicas+jword": 4}


def packed_ops_per_word(mode: str, accept: int, path: str | None = None):
    """32-bit integer operations that one packed word's update (8 spins)
    needs, under ops_per_word's rule. The generator: 8 draws per word (half
    a ChaCha block). Per thread: index and (y, j) 4, and where the thread
    makes more than one generator call the counter base 2 (a ChaCha thread
    makes one call for its pair of words, whose counter call_ops charges).
    Per word: the up / down edge selects, the two rotations and selects of
    the row ends and the off-column choice 7; the xor into dst 1; the
    whole-word sum of 4 neighbours 2; the mirrored count (own bits, their
    0xF masks, 4 - n, the merge) 4; each class word ge_k an add and a mask
    (2, for 2 / 3 / 4 classes). Per field: T > 0 two compares and their set
    bits (4), greedy three (6), the full table the own and 4 class bit
    tests, 9 selects, a compare and a set bit (16). The flip word: 4 (T > 0),
    6 (greedy), none (full table)."""
    family, rounds = parse_rng_mode(mode)
    if family == "hw":   # salted Philox-10
        family, rounds = "philox", 10
    draws, per_call = call_ops(family, rounds)
    nclass, per_field, flip = {packed.ACCEPT_METROPOLIS: (2, 4, 4),
                               packed.ACCEPT_GREEDY: (3, 6, 6),
                               packed.ACCEPT_FIELD: (4, 16, 0)}[accept]
    # the ChaCha thread updates two words
    per_thread = 4 if family == "chacha" else 4 + 2
    words_per_thread = 2 if family == "chacha" else 1
    return (packed.FIELDS / draws * per_call + per_thread / words_per_thread
            + 7 + 1 + 2 + 4 + 2 * nclass + packed.FIELDS * per_field + flip
            + PACKED_PATH_OPS[path])


def dense_ops_per_site(mode: str, path: str | None = None) -> float:
    """32-bit integer operations that one dense site's update needs, under
    ops_per_word's rule, with four sites to a 32-bit word (the kernel's
    layout where G % 4 == 0). The generator: one call per S sites
    (call_ops, with its counter) and its index 1. Per word of four sites:
    the column 1, the off-column word with its wrap (a compare, a select
    and a funnel shift) 3, dst*5 and the sum of 4 neighbour words 3, the
    xor of the flips into dst 1; the J planes' 4 xors. Per site: its byte
    of the index 1, the table's range check 1 (the lookup itself is a
    shared-memory load), the compare 1 and setting its bit 1. mxu computes
    the same function on the same bytes, so its bound counts these too,
    beside its tensor-core products."""
    family, rounds = parse_rng_mode(mode)
    if family == "hw":   # salted Philox-10
        family, rounds = "philox", 10
    draws, per_call = call_ops(family, rounds)
    return ((per_call + 1) / draws + (8 + (4 if path == "jplanes" else 0)) / 4
            + 4)


# Tensor-core work of an mxu site: four m16n8k32 u8 products per 16 x 8
# tile (the dst, vertical, left and right bands), 2 ops per multiply-add.
MXU_OPS_PER_SITE = 4 * 2 * 16 * 8 * 32 / (16 * 8)
INT8_OPS_PER_S = 1979e12    # H100 SXM tensor cores, int8, dense
# mxu_sweep's instantiations (family, rounds, n8 tiles a run): Philox-7/10
# and Threefry-13/20 with two tiles, ChaCha-4/6/8 with two and with one.
MXU_KERNELS = 10


def sass_mix(lib_path: str):
    """({(kernel, template arguments): Counter(pipe -> SASS instructions)},
    the same for each kernel's main loop) of each kernel instantiation, from
    cuobjdump (pipes and loops as ising_tpu_torch/sass.py reads them, each
    kernel keyed by sass.kernel_key): for bit1_sweep (family, rounds,
    greedy, link mode, replica rows), for bit1_planes (family, rounds,
    kbits, accept, link mode, replica rows), for packed_sweep (family,
    rounds, accept, J word, replica rows), for
    packed_fused (family, rounds, accept, cp.async), for dense_sweep
    (family, rounds, sites per word, J planes), for mxu_sweep (family,
    rounds, n8 tiles a run); "tensor" counts HMMA and IMMA.
    The mxu sweep is fully unrolled and branch-free, so its whole function
    is close to the instructions one lane (its warp tile) issues. The main
    loop of bit1's, dense's and packed's sweeps is the pair of rows a
    thread walks (2 words in bit1; 2 S V sites; 2 words, 4 in the packed
    ChaCha kernel), of packed_fused one word's update (a pair of words in
    ChaCha). None without cuobjdump."""
    tool = shutil.which("cuobjdump") or str(
        Path(kernel_lib.find_nvcc()).parent / "cuobjdump")
    try:
        listing = run([tool, "-sass", lib_path], timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None, None
    mix, loops = {}, {}
    for name, instrs in sass.functions(listing).items():
        key = sass.kernel_key(name)
        if key is None:
            continue
        lo_hi = sass.main_loop(instrs)
        mix[key] = sass.mix(instrs, [])["all"]
        loops[key] = sass.mix([i for i in instrs if lo_hi
                               and lo_hi[0] <= i[0] <= lo_hi[1]], [])["all"]
    return mix, loops


def stack_frames(ptxas_lines):
    """{kernel's mangled name: bytes of stack frame} from the -Xptxas -v
    lines: each 'Function properties for NAME' line is followed by its
    'N bytes stack frame' line."""
    frames, name = {}, None
    for line in ptxas_lines:
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m[1]
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name:
            frames[name] = int(m[1])
            name = None
    return frames


def phase_build():
    t0 = time.perf_counter()
    lib, info = kernel_lib.load()
    say(f"[build] nvcc {info.seconds:.1f} s (cached: {info.cached}), "
        f"load {time.perf_counter() - t0:.1f} s total -> {info.path}")
    for line in info.ptxas:
        say(f"[build]   {line.strip()}")
    frames = stack_frames(info.ptxas)
    require(frames and not any(frames.values()),
            "ptxas reports a stack frame in "
            f"{[k for k, v in frames.items() if v]}")
    say(f"[build] no stack frame in any of the {len(frames)} kernels")
    mix, loops = sass_mix(info.path)
    for key, pipes in sorted((mix or {}).items()):
        say(f"[build] SASS {key[0]}{list(key[1])}: "
            f"{sum(pipes.values())} instructions, {dict(pipes)}")
    # the mxu kernel's neighbour sums run on the tensor cores
    mxu_keys = [k for k in (mix or {}) if k[0] == "mxu_sweep"]
    require(len(mxu_keys) == MXU_KERNELS
            and all(mix[k]["tensor"] for k in mxu_keys),
            "no tensor-core instruction (HMMA, IMMA) in the mxu kernel's "
            f"SASS: {mxu_keys}")
    say(f"[build] tensor-core instructions (IMMA) in all {len(mxu_keys)} "
        "mxu_sweep kernels: "
        + ", ".join(f"{list(k[1])} {mix[k]['tensor']}" for k in mxu_keys))
    return info, mix, loops


def random_bits(gen, shape, device):
    return torch.from_numpy(gen.integers(0, 2, shape, dtype=np.uint8)).to(device)


def random_words(gen, shape, device):
    a = gen.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def phase_compare(dev):
    """Kernel vs plain on the same CUDA tensors; returns (cases, max err)."""
    gen = np.random.default_rng(2024)
    cases, max_err = 0, 0
    for Y, X, row0 in COMPARE_SHAPES + BAND_SHAPES:
        H, W1 = Y, X // 64
        steps = COMPARE_STEPS if (Y, X, row0) in COMPARE_SHAPES else 1
        for mode in PORTED_MODES:
            for temp, field in ACCEPTS:
                if field and not bit1.accept_bits(mode):
                    continue
                thr = ising.threshold_table(temp, field)
                b = random_words(gen, (H, W1), dev)
                w = random_words(gen, (H, W1), dev)
                seed = int(gen.integers(0, 1 << 62))
                for step in range(steps):
                    for color, (dst, src) in enumerate(((b, w), (w, b))):
                        kw = dict(color=color, seed=seed, rng_mode=mode,
                                  greedy=temp <= 0,
                                  **bit1.plane_accept_args(mode, temp, field))
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
                                f"{mode} T={temp} h={field} step={step} "
                                f"color={color}")
        say(f"[kernel] {Y}x{X} row0={row0}: all {len(PORTED_MODES)} modes, "
            "T in (1.5, 0) and h = 0.3 in the bit-plane modes and hw, both "
            f"colors, {steps} step(s) equal to the plain version")
    return cases, max_err


def geometry_cases(H: int, W1: int):
    """(path, csl, ysl) of phase 3's disorder and replica cases at (H, W1):
    the edge geometries csl == 1, csl == W1, ysl == 8 and ysl == H, and
    replicas of 6 and 12 rows where they divide H."""
    return [("jplanes", None, None), ("split_links", None, None),
            ("replicas", 1, 8), ("replicas", W1, H),
            ("replicas", next(c for c in range(max(1, W1 // 4), 0, -1)
                              if W1 % c == 0), max(8, H // 4)),
            ("replicas+jplanes", W1, 8), ("replicas+jplanes", 1, H)] + [
        (path, csl, ysl) for path, csl, ysl in (
            ("replicas", W1, 6), ("replicas+jplanes", 1, 12))
        if H % ysl == 0]


def geometry_kwargs(path, csl, ysl, links):
    """bit1_sweep's jplanes and keywords for one path."""
    jplanes = None if path == "replicas" else links
    return jplanes, dict(split_links=path == "split_links", csl=csl, ysl=ysl)


def phase_compare_geometry(dev):
    """Kernel vs plain on the disorder and replica paths, every mode and
    accept, both colors; returns (cases, max err)."""
    gen = np.random.default_rng(2025)
    cases, max_err = 0, 0
    for Y, X, row0 in COMPARE_SHAPES[:2] + tuple(s for s in BAND_SHAPES
                                                 if s[0] == 48):
        H, W1 = Y, X // 64
        for path, csl, ysl in geometry_cases(H, W1):
            for mode in PORTED_MODES:
                for temp, field in ACCEPTS:
                    if field and not bit1.accept_bits(mode):
                        continue
                    thr = ising.threshold_table(temp, field)
                    b, w = (random_words(gen, (H, W1), dev) for _ in range(2))
                    links = [random_words(gen, (H, W1), dev) for _ in range(4)]
                    jplanes, geo = geometry_kwargs(path, csl, ysl, links)
                    seed = int(gen.integers(0, 1 << 62))
                    for color, (dst, src) in enumerate(((b, w), (w, b))):
                        kw = dict(color=color, seed=seed, rng_mode=mode,
                                  greedy=temp <= 0, **geo,
                                  **bit1.plane_accept_args(mode, temp, field))
                        up, dn = src[-1:], src[:1]
                        ref = bit1.bit1_sweep_reference(
                            dst, src, up, dn, thr, row0, 5, jplanes, **kw)
                        bit1.bit1_sweep(dst, src, up, dn, thr, row0, 5,
                                        jplanes, **kw)
                        torch.cuda.synchronize()
                        err = int((dst.to(torch.int64) - ref.to(torch.int64))
                                  .abs().max())
                        max_err = max(max_err, err)
                        cases += 1
                        require(torch.equal(dst, ref),
                                f"kernel != plain: {Y}x{X} {path} csl={csl} "
                                f"ysl={ysl} {mode} T={temp} h={field} "
                                f"color={color}")
            say(f"[kernel] {Y}x{X} row0={row0} {path} csl={csl} ysl={ysl}: "
                f"all {len(PORTED_MODES)} modes, T in (1.5, 0) and h = 0.3 "
                "in the bit-plane modes and hw, both colors equal to the "
                "plain version")
    return cases, max_err


def packed_geometry_cases(H: int, W: int):
    """(path, csl, ysl) of the packed kernel's cases at (H, W): ordered, the
    J word, and the replica edges csl == 1, csl == W, ysl == 8, ysl == H
    and replicas of 6 and 12 rows where they divide H, alone and with the J
    word."""
    return [(None, None, None), ("jword", None, None), ("replicas", 1, 8),
            ("replicas", W, H), ("replicas+jword", W, 8),
            ("replicas+jword", 1, H)] + [
        (path, csl, ysl) for path, csl, ysl in (
            ("replicas", 2, 6), ("replicas+jword", W // 2, 12))
        if H % ysl == 0 and W % csl == 0]


def packed_accepts(mode: str):
    """(temperature, field) of the packed cases: T > 0, the greedy quench
    and the full table (not in hw, whose field config refuses)."""
    return [(t, h) for t, h in ACCEPTS if not h or mode != "hw"]


def packed_kwargs(mode, temp, field, path, csl, ysl):
    return dict(seed=golden.SEED, rng_mode=mode, greedy=temp <= 0,
                full_table=field != 0,
                csl=csl if path and "replicas" in path else None,
                ysl=ysl if path and "replicas" in path else None)


def phase_compare_packed(dev):
    """packed_sweep against its plain version on the same CUDA tensors, at
    every shape, mode and accept, both colors: the ordered path over
    COMPARE_STEPS steps at every shape, the J-word and replica paths at the
    first three. Random words: every bit, bit 31 included, so the 4-bit
    rotation at the row's ends moves set bits. Returns (cases, max err)."""
    gen = np.random.default_rng(2026)
    cases, max_err = 0, 0
    for si, (Y, X, row0) in enumerate(PACKED_COMPARE_SHAPES):
        H, W = Y, X // 16
        geos = packed_geometry_cases(H, W) if si < 3 else [(None,) * 3]
        for path, csl, ysl in geos:
            for mode in PACKED_MODES:
                for temp, field in packed_accepts(mode):
                    thr = ising.threshold_table(temp, field)
                    b, w = (random_words(gen, (H, W), dev) for _ in range(2))
                    jw = (random_words(gen, (H, W), dev)
                          if path and "jword" in path else None)
                    kw = packed_kwargs(mode, temp, field, path, csl, ysl)
                    kw["seed"] = int(gen.integers(0, 1 << 62))
                    for step in range(COMPARE_STEPS if path is None else 1):
                        for color, (dst, src) in enumerate(((b, w), (w, b))):
                            up, dn = src[-1:], src[:1]
                            ref = packed.packed_sweep_reference(
                                dst, src, up, dn, thr, row0, step, jw,
                                color=color, **kw)
                            packed.packed_sweep(dst, src, up, dn, thr, row0,
                                                step, jw, color=color, **kw)
                            torch.cuda.synchronize()
                            err = int((dst.to(torch.int64)
                                       - ref.to(torch.int64)).abs().max())
                            max_err = max(max_err, err)
                            cases += 1
                            require(torch.equal(dst, ref),
                                    f"packed kernel != plain: {Y}x{X} "
                                    f"row0={row0} {path or 'ordered'} "
                                    f"csl={csl} ysl={ysl} {mode} T={temp} "
                                    f"h={field} step={step} color={color}")
            say(f"[kernel] packed {Y}x{X} row0={row0} {path or 'ordered'} "
                f"csl={csl} ysl={ysl}: the {len(PACKED_MODES)} u32 modes and "
                "hw, T in (1.5, 0) and h = 0.3, both colors equal to the "
                "plain version")
    return cases, max_err


def plane_accepts(kernel: str, mode: str):
    """(temperature, field, J planes) of the dense and mxu kernel-vs-plain
    cases: T > 0 and the greedy quench; dense also the full table of the
    field (u32 modes) and the J planes."""
    out = [(1.5, 0.0, False), (0.0, 0.0, False)]
    if kernel == "dense":
        out += [(1.5, 0.3, False)] if mode != "hw" else []
        out += [(1.5, 0.0, True)]
    return out


def phase_compare_planes(dev, kernel: str):
    """dense_sweep or mxu_sweep against its plain version on the same CUDA
    tensors, on random bit planes, in every u32 mode and hw and every
    accept of plane_accepts, both colors; COMPARE_STEPS steps at the small
    shapes, one at 16384^2. Returns (cases, max abs err)."""
    sweep, plain = ((dense.dense_sweep, dense.dense_sweep_reference)
                    if kernel == "dense" else
                    (mxu.mxu_sweep, mxu.mxu_sweep_reference))
    shapes = DENSE_COMPARE_SHAPES if kernel == "dense" else MXU_COMPARE_SHAPES
    gen = np.random.default_rng(2027)
    cases, max_err = 0, 0
    for Y, X, row0 in shapes:
        H, C = Y, X // 2
        for mode in PLANE_MODES:
            for temp, field, jp in plane_accepts(kernel, mode):
                thr = ising.threshold_table(temp, field)
                b, w = (random_bits(gen, (H, C), dev) for _ in range(2))
                extra = ([[random_bits(gen, (H, C), dev) for _ in range(4)]]
                         if jp else [])
                kw = dict(seed=int(gen.integers(0, 1 << 62)), rng_mode=mode)
                for step in range(COMPARE_STEPS if H < 1024 else 1):
                    for color, (dst, src) in enumerate(((b, w), (w, b))):
                        up, dn = src[-1:], src[:1]
                        ref = plain(dst, src, up, dn, thr, row0, step, *extra,
                                    color=color, **kw)
                        sweep(dst, src, up, dn, thr, row0, step, *extra,
                              color=color, **kw)
                        torch.cuda.synchronize()
                        err = int((dst.to(torch.int64)
                                   - ref.to(torch.int64)).abs().max())
                        max_err = max(max_err, err)
                        cases += 1
                        require(torch.equal(dst, ref),
                                f"{kernel} kernel != plain: {Y}x{X} "
                                f"row0={row0} {mode} T={temp} h={field} "
                                f"J={jp} step={step} color={color}")
                del b, w, extra
        say(f"[kernel] {kernel} {Y}x{X} row0={row0}: the "
            f"{len(PLANE_MODES)} u32 modes and hw, T in (1.5, 0)"
            + (", h = 0.3 and J planes" if kernel == "dense" else "")
            + ", both colors equal to the plain version")
    return cases, max_err


def phase_golden():
    """Every golden case on every backend of the port that runs it."""
    for case, want in golden.GOLDEN.items():
        for backend in golden.backends(case):
            got = golden.port_trajectory(*case[:6], device="cuda",
                                         backend=backend)
            require(got == want,
                    f"golden {case} on {backend}: got {got}, want {want}")
        say(f"[golden] {golden.NROWS}x{golden.NCOLS} {case} on "
            f"{', '.join(golden.backends(case))}: up counts {got['up']} and "
            f"crc32 {got['crc32']:08X} match the JAX package")


def cli_simulation(argv):
    """A Simulation (SwendsenWang for --algo sw) from CLI flags, built as
    cli.main builds it."""
    return cli.build_simulation(cli.build_parser().parse_args(argv))


def main_runs(card, mode, extra, runs, e_max, what, backend="bit1",
              shape=MAIN_SHAPE):
    """`runs` CLI runs at shape^2 in `mode` with the flags `extra` on
    `backend`, each from a new Simulation whose set-up (disorder included)
    is timed and whose peak device memory is read; the launch counts of
    every kernel are set to 0 just before each run loop and read just
    after: the kernel the path launches (device_trace.step_launches: two
    sweeps a step, or one fused step under ISING_TPU_FUSED) must show its
    launches a step, the others 0."""
    launches, rates, setups, peaks = 0, [], [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sim = cli_simulation(
            ["--backend", backend, "-x", str(shape), "-y",
             str(shape), "-w", str(MAIN_WARMUP), "-n", str(MAIN_ITERS),
             "-p", "16", "-t", "1.5", "--rng", mode] + extra)
        torch.cuda.synchronize()
        setups.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
        name, per_step = device_trace.step_launches(sim.cfg)
        kernel = STEP_WRAPPERS[name]
        others = [f for f in COUNTERS if f is not kernel]
        for f in COUNTERS:
            f.launches = 0
        result = sim.run()
        n = kernel.launches
        want = per_step * (MAIN_WARMUP + MAIN_ITERS)
        require(result["steps"] == MAIN_ITERS,
                f"ran {result['steps']} of {MAIN_ITERS} steps")
        require(n == want, f"{name} launched {n} times, expected {want}")
        require(not any(f.launches for f in others),
                f"another kernel launched on the {backend} path: "
                f"{[(f.__name__, f.launches) for f in others]}")
        e_n = sim.energy()
        require(math.isfinite(e_n) and e_n < e_max,
                f"E/N = {e_n} after the {what} run (expected < {e_max})")
        if sim.cfg.xsl is not None:
            m = observables.replica_magnetizations(
                *sim.bits(), sim.cfg.xsl, sim.cfg.ysl)
            count = (shape // sim.cfg.xsl) * (shape // sim.cfg.ysl)
            require(m.shape == (count,) and np.all((m >= 0) & (m <= 1)),
                    f"replica |m| of shape {m.shape}, range "
                    f"{m.min()}-{m.max()}")
            say(f"[main] {count} replica |m|: mean {m.mean():.6f}, "
                f"range {m.min():.6f}-{m.max():.6f}")
        launches += n
        rates.append(result["flips_ns"])
        say(f"[main] {shape}^2 {backend} {what} {mode}: {name} "
            f"launches {n} "
            f"(= {per_step} x {MAIN_WARMUP + MAIN_ITERS} steps), E/N "
            f"{e_n:.6f}, {result['flips_ns']:.2f} flips/ns; set-up "
            f"{setups[-1]:.3f} s, peak device memory "
            f"{peaks[-1] / 2**30:.3f} GiB on {card['smi']}")
        del sim
        torch.cuda.empty_cache()
    median = sorted(rates)[len(rates) // 2]
    say(f"[main] {shape}^2 {backend} {what} {mode}: {median:.2f} "
        f"flips/ns median of {runs} runs (range {min(rates):.2f}-"
        f"{max(rates):.2f})")
    return {"kernel": name, "launches": launches, "e_n": e_n,
            "flips_ns": median, "flips_ns_runs": rates, "setup_s": setups,
            "peak_bytes": max(peaks)}


def phase_main_path(card, backend="bit1"):
    """The CLI's flags, parsed and turned into a Simulation as cli.main
    does, then its run loop, which prints the CLI's lines: MAIN_REPEATS
    runs per mode, then the disorder and replica runs of the backend's
    paths. Returns ({mode: result}, {path: {mode: result}})."""
    modes, main_paths = ((MAIN_MODES, MAIN_PATHS) if backend == "bit1"
                         else (PACKED_MAIN_MODES, PACKED_MAIN_PATHS))
    ordered = {mode: main_runs(card, mode, [], MAIN_REPEATS, -1.5, "ordered",
                               backend) for mode in modes}
    paths = collections.defaultdict(dict)
    for path, extra, mode, runs, e_max in main_paths:
        paths[path][mode] = main_runs(card, mode, extra, runs, e_max,
                                      f"{path} ({' '.join(extra)})", backend)
    return ordered, dict(paths)


def phase_plane_main_path(card, backend):
    """dense or mxu through the CLI's flags at bench.py's 8192^2 and at
    16384^2, MAIN_REPEATS runs in each of PLANE_MAIN_MODES; dense also with
    -J 0.1 (threefry13) at 16384^2, its set-up and peak memory timed.
    Returns ({(shape, mode): result}, {"jplanes": {mode: result}})."""
    ordered = {(shape, mode): main_runs(card, mode, [], MAIN_REPEATS, -1.5,
                                        "ordered", backend, shape)
               for shape in PLANE_MAIN_SHAPES for mode in PLANE_MAIN_MODES}
    paths = {}
    if backend == "dense":
        paths["jplanes"] = {"threefry13": main_runs(
            card, "threefry13", J_FLAGS, MAIN_REPEATS, -1.2,
            f"jplanes ({' '.join(J_FLAGS)})", backend)}
    return ordered, paths


def phase_plane_equality(card):
    """At 2048^2 after the CLI's flags, mxu's, dense's, bit1's and xla's
    lattices are equal in threefry13 and philox; dense's and bit1's
    lattices and energy_total with -J 0.1; mxu's, dense's and packed's in
    hw (one salted Philox-10 u32 per spin). The first two backends of each
    run are checked to launch their own kernel 2 per step."""
    for mode, extra, backends in PLANE_EQUALITY_RUNS:
        flags = ["-x", str(EQUALITY_SHAPE), "-y", str(EQUALITY_SHAPE), "-n",
                 str(EQUALITY_ITERS), "-p", "4", "-t", "1.5", "--rng",
                 mode] + extra
        sims = {be: cli_simulation(flags + ["--backend", be])
                for be in backends}
        rates = {}
        for be, sim in sims.items():
            for f in COUNTERS:
                f.launches = 0
            rates[be] = sim.run()["flips_ns"]
            if be in SWEEPS:
                n = SWEEPS[be].launches
                require(n == 2 * EQUALITY_ITERS,
                        f"{be} launched {n} times at {EQUALITY_SHAPE}^2")
        first = backends[0]
        for be in backends[1:]:
            for a, b in zip(sims[first].bits(), sims[be].bits()):
                require(torch.equal(a, b),
                        f"{first} != {be} at {EQUALITY_SHAPE}^2 {mode} "
                        f"{' '.join(extra)}")
        energies = {be: sims[be].energy_total() for be in backends}
        require(len(set(energies.values())) == 1,
                f"energy_total differs: {energies}")
        say(f"[planes] {EQUALITY_SHAPE}^2 {mode} {' '.join(extra)}: "
            f"lattices of {', '.join(backends)} equal after {EQUALITY_ITERS} "
            f"steps, energy_total {energies[first]}; flips/ns "
            + ", ".join(f"{be} {r:.2f}" for be, r in rates.items())
            + f" on {card['smi']}")


def phase_xla_path(card):
    """The CLI's default backend, xla (plain torch, no kernel), at the
    CLI's default 2048^2 and default rng mode, and in chacha6b: its
    lattice must equal bit1's after the same flags, bit for bit."""
    for mode in XLA_MODES:
        flags = ["-x", str(XLA_SHAPE), "-y", str(XLA_SHAPE), "-n",
                 str(XLA_ITERS), "-p", "4", "-t", "1.5"]
        if mode != cli.build_parser().get_default("rng"):
            flags += ["--rng", mode]
        xla = cli_simulation(flags)
        require(xla.cfg.backend == "xla", "the CLI default is not xla")
        bit1.bit1_sweep.launches = 0
        result = xla.run()
        require(bit1.bit1_sweep.launches == 0, "xla launched a bit1 kernel")
        ref = cli_simulation(flags + ["--backend", "bit1"])
        ref.run()
        for a, b in zip(xla.bits(), ref.bits()):
            require(torch.equal(a, b),
                    f"xla != bit1 at {XLA_SHAPE}^2 {mode} after "
                    f"{XLA_ITERS} steps")
        e_n = xla.energy()
        require(e_n == ref.energy() and e_n < -1.0,
                f"xla E/N {e_n}, bit1 E/N {ref.energy()}")
        say(f"[xla] {XLA_SHAPE}^2 {mode}: lattice after {XLA_ITERS} steps "
            f"equal to bit1's, E/N {e_n:.6f}, {result['flips_ns']:.3f} "
            f"flips/ns (plain torch) on {card['smi']}")
    flags = ["-x", str(XLA_SHAPE), "-y", str(XLA_SHAPE), "-n", str(XLA_ITERS),
             "-p", "4", "-t", "1.5"] + XLA_GEOMETRY_FLAGS
    xla = cli_simulation(flags)
    ref = cli_simulation(flags + ["--backend", "bit1"])
    require(not ref.backend.split_links
            and ref.backend.csl == ref.cfg.xsl // 2,
            "bit1 with replicas should take J planes and csl = xsl/2")
    bit1.bit1_sweep.launches = 0
    result = xla.run()
    require(bit1.bit1_sweep.launches == 0, "xla launched a bit1 kernel")
    ref.run()
    for a, b in zip(xla.bits(), ref.bits()):
        require(torch.equal(a, b), f"xla != bit1 at {XLA_SHAPE}^2 with "
                f"{' '.join(XLA_GEOMETRY_FLAGS)}")
    e_x, e_b = xla.energy_total(), ref.energy_total()
    require(e_x == e_b, f"xla energy_total {e_x}, bit1 {e_b}")
    say(f"[xla] {XLA_SHAPE}^2 {' '.join(XLA_GEOMETRY_FLAGS)}: lattice and "
        f"energy_total ({e_x}) after {XLA_ITERS} steps equal to bit1's, "
        f"{result['flips_ns']:.3f} flips/ns (plain torch) on {card['smi']}")


def phase_packed_equality(card):
    """packed's lattice after the CLI's flags at 2048^2 equals bit1's and
    xla's, and its energy_total xla's: in threefry13, and in chacha8 with
    -J 0.1 --xsl 64 --ysl 64 (csl = 32 divides W = 128)."""
    for mode, extra in EQUALITY_RUNS:
        flags = ["-x", str(EQUALITY_SHAPE), "-y", str(EQUALITY_SHAPE), "-n",
                 str(EQUALITY_ITERS), "-p", "4", "-t", "1.5", "--rng",
                 mode] + extra
        sims = {be: cli_simulation(flags + ["--backend", be])
                for be in ("packed", "bit1", "xla")}
        packed.packed_sweep.launches = 0
        result = sims["packed"].run()
        n = packed.packed_sweep.launches
        require(n == 2 * EQUALITY_ITERS,
                f"packed_sweep launched {n} times at {EQUALITY_SHAPE}^2")
        for be in ("bit1", "xla"):
            sims[be].run()
            for a, b in zip(sims["packed"].bits(), sims[be].bits()):
                require(torch.equal(a, b),
                        f"packed != {be} at {EQUALITY_SHAPE}^2 {mode} "
                        f"{' '.join(extra)}")
        e_p, e_x = (sims[be].energy_total() for be in ("packed", "xla"))
        require(e_p == e_x, f"packed energy_total {e_p}, xla {e_x}")
        say(f"[packed] {EQUALITY_SHAPE}^2 {mode} {' '.join(extra)}: lattice "
            f"after {EQUALITY_ITERS} steps equal to bit1's and xla's, "
            f"energy_total ({e_p}) equal to xla's, {n} launches, "
            f"{result['flips_ns']:.2f} flips/ns on {card['smi']}")


def time_launches(fn, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def compare_and_time(what: str, kernel, plain, args):
    """`kernel` against its `plain` version for both colors (bit for bit),
    then the kernel's time per launch (median of TIMED_REPEATS x
    TIMED_LAUNCHES, with their range) and the plain version's. args(i) ->
    (positional, keyword arguments) of launch i, whose dst is positional
    argument 0. Returns (ms, sorted runs, plain ms, max abs err)."""
    max_err = 0
    for i in range(2):   # black then white, at the main path's shape
        a, k = args(i)
        ref = plain(*a, **k)
        kernel(*a, **k)
        torch.cuda.synchronize()
        err = int((a[0].to(torch.int64) - ref.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        require(torch.equal(a[0], ref), f"kernel != plain at {what} color={i}")

    def launch(fn):
        def call(i):
            a, k = args(i)
            fn(*a, **k)
        return call

    time_launches(launch(kernel), 10)
    runs = sorted(time_launches(launch(kernel), TIMED_LAUNCHES)
                  for _ in range(TIMED_REPEATS))
    launch(plain)(0)
    return (runs[len(runs) // 2], runs,
            time_launches(launch(plain), PLAIN_LAUNCHES), max_err)


def timing_cases():
    """(mode, field, path) triples that phase 6 times: every mode without a
    field, then every bit-plane mode and hw with TIMED_FIELD, then each
    disorder and replica path in TIMED_PATH_MODES."""
    return ([(mode, 0.0, None) for mode in PORTED_MODES]
            + [(mode, TIMED_FIELD, None) for mode in PORTED_MODES
               if bit1.accept_bits(mode)]
            + [(mode, 0.0, path) for path in GEOMETRY_PATHS
               for mode in TIMED_PATH_MODES])


# The template arguments of a bit1 kernel after (family, rounds) and the
# accept: the link mode and whether there are replica rows, by path.
BIT1_PATH_ARGS = {None: (bit1.LINKS_NONE, 0), "jplanes": (bit1.LINKS_JPLANES, 0),
                  "split_links": (bit1.LINKS_SPLIT, 0),
                  "replicas": (bit1.LINKS_NONE, 1),
                  "replicas+jplanes": (bit1.LINKS_JPLANES, 1)}


def bit1_kernel_key(mode: str, field: float, path: str | None):
    """sass_mix's key of the bit1 kernel that phase 6 times for (mode, field
    at T = 1.5, path): bit1_planes (family, rounds, kbits, accept, links,
    replica rows) or bit1_sweep (family, rounds, greedy, links, replica
    rows)."""
    family, rounds = parse_rng_mode(mode)
    kbits = bit1.accept_bits(mode)
    if family == "hw":
        family, rounds = "philox", 10
    code = bit1._FAMILY_CODE[family]
    if kbits:
        accept = bit1.ACCEPT_FIELD if field else bit1.ACCEPT_METROPOLIS
        return "bit1_planes", (code, rounds, kbits, accept, *BIT1_PATH_ARGS[path])
    return "bit1_sweep", (code, rounds, 0, *BIT1_PATH_ARGS[path])


def phase_timing(card, loops):
    """Per color phase at 16384^2, at T = 1.5, in every rng mode, in the
    bit-plane modes and hw with a field, and on the disorder and replica
    paths (replicas of --xsl 128 --ysl 128): kernel against plain (bit for
    bit), then the kernel's and the plain version's times, and the bound.
    Returns ({(mode, field, path): timing}, compared cases, max abs err)."""
    dev = torch.device("cuda")
    gen = np.random.default_rng(7)
    H, W1 = MAIN_SHAPE, MAIN_SHAPE // 64
    planes = [random_words(gen, (H, W1), dev) for _ in range(2)]
    links = [random_words(gen, (H, W1), dev) for _ in range(4)]
    words = H * W1
    spins = words * 32
    rate = card["sms"] * INT_OPS_PER_SM_CLOCK * card["clock_hz"]
    pipe_rate = card["sms"] * PIPE_LANES_PER_SM * card["clock_hz"]
    out, cases, max_err = {}, 0, 0
    for mode, field, path in timing_cases():
        thr = ising.threshold_table(1.5, field)
        acc = bit1.plane_accept_args(mode, 1.5, field)
        jplanes, geo = (None, {}) if path is None else geometry_kwargs(
            path, *((TIMED_CSL, TIMED_YSL) if "replicas" in path
                    else (None, None)), links)
        kw = dict(seed=golden.SEED, rng_mode=mode, greedy=False, **acc, **geo)
        what = (f"{mode}" + (f" h={field}" if field else "")
                + (f" {path}" if path else ""))

        def args(i):
            dst, src = planes[i % 2], planes[1 - i % 2]
            return (dst, src, src[-1:], src[:1], thr, 0, i, jplanes), dict(
                color=i % 2, **kw)

        ms, runs, plain_ms, err = compare_and_time(
            f"{H}x{MAIN_SHAPE} {what}", bit1.bit1_sweep,
            bit1.bit1_sweep_reference, args)
        max_err, cases = max(max_err, err), cases + 2
        say(f"[timing] {MAIN_SHAPE}^2 {what}: kernel equal to the plain "
            "version for both colors")
        nbytes = PATH_WORDS[path] * words * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops = ops_per_word(mode, greedy=False, field_table=(
            (acc["tvals10"], acc["always10"]) if field else None), path=path)
        ops_ms = ops * words / rate * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "operations" if ops_ms > bytes_ms else "bytes"
        pipes = dict((loops or {}).get(bit1_kernel_key(mode, field, path), {}))
        # a pass of the loop: a pair of rows of the thread's word
        per_word = {p: pipes[p] / 2 for p in ("alu", "fma") if p in pipes}
        pipe_ms = {p: n * words / pipe_rate * 1e3 for p, n in per_word.items()}
        ordered = out.get((mode, 0.0, None), {}).get("ms")
        out[(mode, field, path)] = {
            "ms": ms, "ms_runs": runs, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes_ms": bytes_ms,
            "ops_per_word": ops, "ops_ms": ops_ms, "sass_per_pass": pipes,
            "sass_per_word": per_word, "pipe_ms": pipe_ms}
        say(f"[timing] {MAIN_SHAPE}^2 {what}, one color phase: kernel "
            f"{ms:.4f} ms median of {TIMED_REPEATS} x {TIMED_LAUNCHES} "
            f"launches (range {runs[0]:.4f}-{runs[-1]:.4f}; "
            f"{spins / ms / 1e6:.1f} flips/ns"
            + (f"; {ms / ordered:.3f}x the ordered {ordered:.4f} ms"
               if path else "")
            + f"), plain {plain_ms:.2f} ms; "
            f"bound {bound_ms:.4f} ms by {bound_by} (bytes {bytes_ms:.4f} "
            f"ms; {ops} integer ops/word -> {ops_ms:.4f} ms), "
            f"{bound_ms / ms:.1%} of bound; compiled code per pass of the "
            f"row pair {pipes}; "
            + ", ".join(f"{p.upper()} {n:.1f}" for p, n in per_word.items())
            + f" instructions a word, at {PIPE_LANES_PER_SM} lanes/SM per pipe "
            + ", ".join(f"{p} {t:.4f} ms" for p, t in pipe_ms.items())
            + f", on {card['smi']}")
    require(all(v["sass_per_word"] for v in out.values()) or loops is None,
            "no compiled-code count for the bit1 cases "
            f"{[k for k, v in out.items() if not v['sass_per_word']]}")
    return out, cases, max_err


def packed_timing_cases():
    """(mode, field, path) triples of the packed kernel that phase 6 times:
    every u32 mode and hw ordered, the field in PACKED_TIMED_FIELD_MODES,
    then each J-word and replica path in PACKED_TIMED_PATH_MODES."""
    return ([(mode, 0.0, None) for mode in PACKED_MODES]
            + [(mode, TIMED_FIELD, None) for mode in PACKED_TIMED_FIELD_MODES]
            + [(mode, 0.0, path) for path in PACKED_PATHS
               for mode in PACKED_TIMED_PATH_MODES])


def phase_timing_packed(card, loops, bit1_timing):
    """packed_sweep per color phase at 16384^2 (W = 1024), T = 1.5, on
    random words: kernel against plain (bit for bit, both colors), then the
    kernel's and the plain version's times, the bound, bit1's time in the
    same mode and path (bit1_timing; None where phase 6 did not time it),
    and the ALU and FMA instructions a word in the kernel's main loop (a
    pair of rows of a thread's words: 2 words, 4 in ChaCha). Returns
    ({(mode, field, path): timing}, cases, max abs err)."""
    dev = torch.device("cuda")
    gen = np.random.default_rng(8)
    H, W = MAIN_SHAPE, MAIN_SHAPE // 16
    planes = [random_words(gen, (H, W), dev) for _ in range(2)]
    jword = random_words(gen, (H, W), dev)
    words = H * W
    spins = words * packed.FIELDS
    rate = card["sms"] * INT_OPS_PER_SM_CLOCK * card["clock_hz"]
    pipe_rate = card["sms"] * PIPE_LANES_PER_SM * card["clock_hz"]
    out, cases, max_err = {}, 0, 0
    for mode, field, path in packed_timing_cases():
        thr = ising.threshold_table(1.5, field)
        kw = packed_kwargs(mode, 1.5, field, path, TIMED_CSL, TIMED_YSL)
        jw = jword if path and "jword" in path else None
        what = (f"packed {mode}" + (f" h={field}" if field else "")
                + (f" {path}" if path else ""))

        def args(i):
            dst, src = planes[i % 2], planes[1 - i % 2]
            return (dst, src, src[-1:], src[:1], thr, 0, i, jw), dict(
                color=i % 2, **kw)

        ms, runs, plain_ms, err = compare_and_time(
            f"{H}x{MAIN_SHAPE} {what}", packed.packed_sweep,
            packed.packed_sweep_reference, args)
        max_err, cases = max(max_err, err), cases + 2
        bytes_ms = PACKED_PATH_WORDS[path] * words * 4 / HBM_BYTES_PER_S * 1e3
        accept = (packed.ACCEPT_FIELD if field else packed.ACCEPT_METROPOLIS)
        ops = packed_ops_per_word(mode, accept, path)
        ops_ms = ops * words / rate * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "operations" if ops_ms > bytes_ms else "bytes"
        family, rounds = parse_rng_mode(mode)
        if family == "hw":
            family, rounds = "philox", 10
        pipes = dict((loops or {}).get(("packed_sweep", (
            bit1._FAMILY_CODE[family], rounds, accept,
            int(path is not None and "jword" in path),
            int(path is not None and "replicas" in path))), {}))
        # a pass of the loop: two rows of the thread's words (two in ChaCha)
        per = 2 * (2 if family == "chacha" else 1)
        per_word = {p: pipes[p] / per for p in ("alu", "fma") if p in pipes}
        pipe_ms = {p: n * words / pipe_rate * 1e3 for p, n in per_word.items()}
        bit1_ms = None if field else bit1_timing.get(
            (mode, 0.0, BIT1_PATH_OF[path]), {}).get("ms")
        ordered = out.get((mode, 0.0, None), {}).get("ms")
        out[(mode, field, path)] = {
            "ms": ms, "ms_runs": runs, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes_ms": bytes_ms,
            "ops_per_word": ops, "ops_ms": ops_ms, "sass_per_pass": pipes,
            "sass_per_word": per_word, "pipe_ms": pipe_ms, "bit1_ms": bit1_ms}
        say(f"[timing] {MAIN_SHAPE}^2 {what}, one color phase: kernel "
            f"{ms:.4f} ms median of {TIMED_REPEATS} x {TIMED_LAUNCHES} "
            f"launches (range {runs[0]:.4f}-{runs[-1]:.4f}; "
            f"{spins / ms / 1e6:.1f} flips/ns"
            + (f"; {ms / ordered:.3f}x the ordered {ordered:.4f} ms"
               if path else "")
            + f"), plain {plain_ms:.2f} ms; bound {bound_ms:.4f} ms by "
            f"{bound_by} (bytes {bytes_ms:.4f} ms; {ops:.1f} integer "
            f"ops/word -> {ops_ms:.4f} ms), {bound_ms / ms:.1%} of bound; "
            + (f"bit1 {bit1_ms:.4f} ms; " if bit1_ms else "")
            + f"compiled code per pass of the row pair {pipes}; "
            + ", ".join(f"{p.upper()} {n:.2f}" for p, n in per_word.items())
            + " instructions a word"
            + "".join(f", {p} {t:.4f} ms" for p, t in pipe_ms.items())
            + f", on {card['smi']}")
    return out, cases, max_err


def plane_timing_cases():
    """(kernel, mode, field, path) of the dense and mxu kernels that phase 6
    times: every u32 mode and hw, dense also with its J planes and with
    the field in PACKED_TIMED_FIELD_MODES."""
    return ([("dense", m, 0.0, None) for m in PLANE_MODES]
            + [("dense", m, 0.0, "jplanes") for m in PLANE_MODES]
            + [("dense", m, TIMED_FIELD, None)
               for m in PACKED_TIMED_FIELD_MODES]
            + [("mxu", m, 0.0, None) for m in PLANE_MODES])


def phase_timing_planes(card, mix, loops, bit1_timing):
    """dense_sweep and mxu_sweep per color phase at 16384^2 and 8192^2, T =
    1.5 (h = 0.3 where a field is timed), on random bit planes: kernel
    against plain (bit for bit, both colors), then the kernel's and the
    plain version's times, the bound (bytes, integer operations and, for
    mxu, the tensor-core products at the int8 rate) and the compiled
    code's ALU and FMA instructions a site with their pipes' time (dense:
    its main loop over the 2 S V sites of a pair of rows; mxu: an mxu lane's
    calls of one warp tile), beside bit1's time in the same mode at
    16384^2. Returns
    ({(kernel, mode, field, path, shape): timing}, cases, max abs err)."""
    dev = torch.device("cuda")
    gen = np.random.default_rng(9)
    rate = card["sms"] * INT_OPS_PER_SM_CLOCK * card["clock_hz"]
    pipe_rate = card["sms"] * PIPE_LANES_PER_SM * card["clock_hz"]
    out, cases, max_err = {}, 0, 0
    for shape in PLANE_TIMED_SHAPES:
        H, C = shape, shape // 2
        planes = [random_bits(gen, (H, C), dev) for _ in range(2)]
        jplanes = [random_bits(gen, (H, C), dev) for _ in range(4)]
        sites = H * C
        for kernel, mode, field, path in plane_timing_cases():
            thr = ising.threshold_table(1.5, field)
            sweep, plain = ((dense.dense_sweep, dense.dense_sweep_reference)
                            if kernel == "dense" else
                            (mxu.mxu_sweep, mxu.mxu_sweep_reference))
            extra = (jplanes,) if path else ()
            what = (f"{kernel} {mode}" + (f" h={field}" if field else "")
                    + (f" {path}" if path else ""))

            def args(i):
                dst, src = planes[i % 2], planes[1 - i % 2]
                return (dst, src, src[-1:], src[:1], thr, 0, i, *extra), dict(
                    color=i % 2, seed=golden.SEED, rng_mode=mode)

            ms, runs, plain_ms, err = compare_and_time(
                f"{H}x{shape} {what}", sweep, plain, args)
            max_err, cases = max(max_err, err), cases + 2
            bytes_ms = PLANE_PATH_BYTES[path] * sites / HBM_BYTES_PER_S * 1e3
            ops = dense_ops_per_site(mode, path)
            mma_ms = (MXU_OPS_PER_SITE * sites / INT8_OPS_PER_S * 1e3
                      if kernel == "mxu" else 0.0)
            ops_ms = max(ops * sites / rate * 1e3, mma_ms)
            bound_ms = max(bytes_ms, ops_ms)
            bound_by = "operations" if ops_ms > bytes_ms else "bytes"
            family, rounds = parse_rng_mode(mode)
            if family == "hw":
                family, rounds = "philox", 10
            # a dense thread serves V calls a row (V = 4 where the row's
            # calls come in fours), S * V sites, and its main loop two rows;
            # an mxu lane 2 * cols/4 calls of each warp tile, S sites each,
            # in one unrolled pass of its loop (the static count adds its
            # constant operands once)
            per = dense.SITES_PER_CALL[family]
            V = 4 if (C // per) % 4 == 0 else 1
            if kernel == "dense":
                targs = (bit1._FAMILY_CODE[family], rounds, V, int(bool(path)))
                pipes = dict((loops or {}).get(("dense_sweep", targs), {}))
                per_thread = 2 * per * V
            else:
                V = 2 * mxu.tile_columns(C, mode) // 4
                targs = (bit1._FAMILY_CODE[family], rounds,
                         mxu.tile_columns(C, mode) // mxu.N8)
                pipes = dict((mix or {}).get(("mxu_sweep", targs), {}))
                per_thread = per * V
            per_site = {p: pipes[p] / per_thread for p in ("alu", "fma")
                        if p in pipes}
            pipe_ms = {p: n * sites / pipe_rate * 1e3
                       for p, n in per_site.items()}
            bit1_ms = (bit1_timing.get((mode, 0.0, None), {}).get("ms")
                       if shape == MAIN_SHAPE and not field and not path
                       else None)
            ordered = out.get((kernel, mode, 0.0, None, shape), {}).get("ms")
            out[(kernel, mode, field, path, shape)] = {
                "ms": ms, "ms_runs": runs, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes_ms": bytes_ms, "ops_per_site": ops, "ops_ms": ops_ms,
                "mma_ms": mma_ms, "sass_per_thread": pipes,
                "sass_per_site": per_site, "pipe_ms": pipe_ms,
                "bit1_ms": bit1_ms}
            say(f"[timing] {shape}^2 {what}, one color phase: kernel "
                f"{ms:.4f} ms median of {TIMED_REPEATS} x {TIMED_LAUNCHES} "
                f"launches (range {runs[0]:.4f}-{runs[-1]:.4f}; "
                f"{sites / ms / 1e6:.1f} flips/ns"
                + (f"; {ms / ordered:.3f}x the ordered {ordered:.4f} ms"
                   if path or field else "")
                + f"), plain {plain_ms:.2f} ms; bound {bound_ms:.4f} ms by "
                f"{bound_by} (bytes {bytes_ms:.4f} ms; {ops:.2f} ops/site -> "
                f"{ops * sites / rate * 1e3:.4f} ms"
                + (f"; tensor cores {mma_ms:.4f} ms" if mma_ms else "")
                + f"), {bound_ms / ms:.1%} of bound; "
                + (f"bit1 {bit1_ms:.4f} ms ({ms / bit1_ms:.2f}x); "
                   if bit1_ms else "")
                + ("compiled code per pass of the row pair"
                   if kernel == "dense" else "compiled code per thread")
                + f" {pipes}; "
                + ", ".join(f"{p.upper()} {n:.2f}" for p, n in per_site.items())
                + " instructions a site"
                + "".join(f", {p} {t:.4f} ms" for p, t in pipe_ms.items())
                + f", on {card['smi']}")
        del planes, jplanes
        torch.cuda.empty_cache()
    return out, cases, max_err


@contextlib.contextmanager
def fused_env(fused, block_rows=None):
    """ISING_TPU_FUSED and ISING_TPU_FUSED_BY as given (None: unset) for
    the block, then as they were."""
    names = ("ISING_TPU_FUSED", "ISING_TPU_FUSED_BY")
    saved = {k: os.environ.get(k) for k in names}
    try:
        for k, v in zip(names, (fused, block_rows)):
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def two_calls(black, white, thr, row0, step, **kw):
    """(black', white') of two packed_sweep kernel launches, on copies."""
    b, w = black.clone(), white.clone()
    packed.packed_sweep(b, w, w[-1:], w[:1], thr, row0, step, color=0, **kw)
    packed.packed_sweep(w, b, b[-1:], b[:1], thr, row0, step, color=1, **kw)
    return b, w


def fused_against(what, got, want):
    """Both planes of a fused step against `want`, bit for bit; returns the
    max abs err of the words."""
    err = 0
    for g, r, color in zip(got, want, ("black", "white")):
        err = max(err, int((g.to(torch.int64) - r.to(torch.int64))
                           .abs().max()))
        require(torch.equal(g, r), f"{what}: {color} differs")
    return err


def phase_compare_fused(dev):
    """Both fused kernels against the plain fused step and two packed_sweep
    launches, bit for bit, both planes, at every shape of
    FUSED_COMPARE_SHAPES, in every u32 mode and hw, at T > 0, T = 0 and
    h = 0.3 (not hw), on random words (bit 31 set in half of them); the
    inputs must come back unchanged. Returns (cases, max abs err)."""
    gen = np.random.default_rng(2028)
    cases, max_err = 0, 0
    for Y, X, row0, band in FUSED_COMPARE_SHAPES:
        H, W = Y, X // 16
        for mode in PACKED_MODES:
            for temp, field in packed_accepts(mode):
                thr = ising.threshold_table(temp, field)
                b, w = (random_words(gen, (H, W), dev) for _ in range(2))
                b0, w0 = b.clone(), w.clone()
                kw = dict(seed=int(gen.integers(0, 1 << 62)), rng_mode=mode,
                          greedy=temp <= 0, full_table=field != 0)
                step = int(gen.integers(0, 1 << 32))
                what = (f"{Y}x{X} row0={row0} band={band} {mode} T={temp} "
                        f"h={field}")
                ref = packed.packed_fused_step_reference(b, w, thr, row0,
                                                         step, **kw)
                fused_against(f"two packed_sweep launches != plain at {what}",
                              two_calls(b, w, thr, row0, step, **kw), ref)
                for fn in FUSED.values():
                    got = fn(b, w, thr, row0, step, band_rows=band, **kw)
                    torch.cuda.synchronize()
                    max_err = max(max_err, fused_against(
                        f"{fn.__name__} != plain at {what}", got, ref))
                    require(torch.equal(b, b0) and torch.equal(w, w0),
                            f"{fn.__name__} changed its inputs at {what}")
                    cases += 1
        say(f"[kernel] fused {Y}x{X} row0={row0} band {band or 'default'}: "
            f"both kernels, the {len(PACKED_MODES)} u32 modes and hw, T in "
            "(1.5, 0) and h = 0.3, both planes equal to the plain step and "
            "to two packed_sweep launches")
    return cases, max_err


def fused_golden_cases():
    """The packed golden cases a fused step may take: no -J, no replicas."""
    return [case for case in golden.GOLDEN
            if "packed" in golden.backends(case)
            and not (len(case) > 3 and (case[3] is not None
                                        or case[4] is not None))]


def phase_fused_golden():
    """Each such golden case under ISING_TPU_FUSED=1 and =2 (=2 with
    ISING_TPU_FUSED_BY=16): where fusable takes it, one fused launch a
    step and no packed_sweep; else the two-call path. Either way the JAX
    package's trajectory."""
    for var, fn in FUSED.items():
        with fused_env(var, FUSED_GOLDEN_BY if var == "2" else None):
            for case in fused_golden_cases():
                field = case[2] if len(case) > 2 else 0.0
                fusable = packed.PackedBackend(SimConfig(
                    nrows=golden.NROWS, ncols=golden.NCOLS, rng=case[0],
                    temp=case[1], field=field, backend="packed")).fusable(
                        golden.NROWS)
                for f in COUNTERS:
                    f.launches = 0
                got = golden.port_trajectory(*case[:6], device="cuda",
                                             backend="packed")
                want = golden.GOLDEN[case]
                require(got == want, f"golden {case} under ISING_TPU_FUSED="
                        f"{var}: got {got}, want {want}")
                counts = (fn.launches, packed.packed_sweep.launches)
                require(counts == ((golden.NSTEPS, 0) if fusable
                                   else (0, 2 * golden.NSTEPS)),
                        f"golden {case} under ISING_TPU_FUSED={var}: "
                        f"{fn.__name__} and packed_sweep launched {counts}")
                say(f"[golden] ISING_TPU_FUSED={var} {case}: "
                    + (f"{fn.__name__} once a step" if fusable else
                       "not fusable (fewer than 3 row blocks), two "
                       "packed_sweep launches a step")
                    + f", up counts and crc32 {got['crc32']:08X} match")


def phase_fused_main_path(card):
    """The CLI at 16384^2 under ISING_TPU_FUSED=1 and =2: FUSED_MAIN_RUNS,
    each run reading the fused counter (one a step) and packed_sweep's
    (0); then -J 0.1 under =1, where fusable is false, as in the JAX
    package: packed_sweep twice a step, the fused counters at 0. Returns
    {(variable, what, mode): result}."""
    out = {}
    for var, fn in FUSED.items():
        with fused_env(var):
            for what, extra, modes, runs, e_max in FUSED_MAIN_RUNS:
                for mode in modes:
                    r = main_runs(card, mode, extra, runs, e_max,
                                  f"ISING_TPU_FUSED={var} {what}", "packed")
                    require(r["kernel"] == fn.__name__,
                            f"ISING_TPU_FUSED={var} {what} {mode} launched "
                            f"{r['kernel']}")
                    out[(var, what, mode)] = r
    with fused_env("1"):
        r = main_runs(card, "threefry13", J_FLAGS, 1, -1.2,
                      f"ISING_TPU_FUSED=1 jword ({' '.join(J_FLAGS)})",
                      "packed")
    require(r["kernel"] == "packed_sweep",
            f"-J 0.1 under ISING_TPU_FUSED=1 launched {r['kernel']}")
    out[("1", "jword", "threefry13")] = r
    return out


def phase_fused_equality(card):
    """At 2048^2 after the CLI's flags, the lattice and energy_total under
    ISING_TPU_FUSED=1 and =2 equal the two-call packed path's and bit1's,
    in FUSED_EQUALITY_MODES."""
    for mode in FUSED_EQUALITY_MODES:
        flags = ["-x", str(EQUALITY_SHAPE), "-y", str(EQUALITY_SHAPE), "-n",
                 str(EQUALITY_ITERS), "-p", "4", "-t", "1.5", "--rng", mode,
                 "--backend"]
        refs = {be: cli_simulation(flags + [be]) for be in ("packed", "bit1")}
        for sim in refs.values():
            sim.run()
        energy = refs["packed"].energy_total()
        require(energy == refs["bit1"].energy_total(),
                f"packed and bit1 energy_total differ at {mode}")
        for var, fn in FUSED.items():
            with fused_env(var):
                sim = cli_simulation(flags + ["packed"])
                for f in COUNTERS:
                    f.launches = 0
                result = sim.run()
            counts = (fn.launches, packed.packed_sweep.launches)
            require(counts == (EQUALITY_ITERS, 0),
                    f"ISING_TPU_FUSED={var} at {EQUALITY_SHAPE}^2 {mode}: "
                    f"{fn.__name__} and packed_sweep launched {counts}")
            for be, ref in refs.items():
                for a, b in zip(sim.bits(), ref.bits()):
                    require(torch.equal(a, b),
                            f"ISING_TPU_FUSED={var} != {be} at "
                            f"{EQUALITY_SHAPE}^2 {mode}")
            require(sim.energy_total() == energy,
                    f"ISING_TPU_FUSED={var} energy_total "
                    f"{sim.energy_total()}, two calls {energy}")
            say(f"[fused] {EQUALITY_SHAPE}^2 {mode} ISING_TPU_FUSED={var}: "
                f"lattice after {EQUALITY_ITERS} steps equal to the two-call "
                f"packed path's and bit1's, energy_total {energy}, "
                f"{counts[0]} {fn.__name__} launches, "
                f"{result['flips_ns']:.2f} flips/ns on {card['smi']}")


def median_ms(fn, n=TIMED_LAUNCHES):
    """(median ms of TIMED_REPEATS x n calls fn(i), sorted runs)."""
    time_launches(fn, 10)
    runs = sorted(time_launches(fn, n) for _ in range(TIMED_REPEATS))
    return runs[len(runs) // 2], runs


def phase_timing_fused(card, loops):
    """Per step at 16384^2 (W = 1024), T = 1.5, on random words, in every
    u32 mode and hw: both fused kernels against the plain step (both
    planes, bit for bit), then each timed at its default band and at
    FUSED_TIMED_BAND rows, beside two packed_sweep launches a step in the
    same mode, the plain step, the bound (4 planes; twice a half-sweep's
    operations) and the ALU and FMA instructions a word in the compiled
    kernel's main loop (one word's update, a ChaCha pair's in ChaCha).
    Returns ({mode: {variable: timing}}, cases, max abs err)."""
    dev = torch.device("cuda")
    gen = np.random.default_rng(10)
    H, W = MAIN_SHAPE, MAIN_SHAPE // 16
    b, w = (random_words(gen, (H, W), dev) for _ in range(2))
    words = H * W
    rate = card["sms"] * INT_OPS_PER_SM_CLOCK * card["clock_hz"]
    bytes_ms = 4 * words * 4 / HBM_BYTES_PER_S * 1e3
    out, cases, max_err = {}, 0, 0
    for mode in PACKED_MODES:
        thr = ising.threshold_table(1.5)
        kw = dict(seed=golden.SEED, rng_mode=mode)
        ref = packed.packed_fused_step_reference(b, w, thr, 0, 1, **kw)
        d, s = b.clone(), w.clone()

        def two(i):
            packed.packed_sweep(d, s, s[-1:], s[:1], thr, 0, i, color=0, **kw)
            packed.packed_sweep(s, d, d[-1:], d[:1], thr, 0, i, color=1, **kw)

        two_ms, two_runs = median_ms(two)
        plain_ms = time_launches(lambda i: packed.packed_fused_step_reference(
            b, w, thr, 0, i, **kw), PLAIN_LAUNCHES)
        ops = 2 * packed_ops_per_word(mode, packed.ACCEPT_METROPOLIS)
        ops_ms = ops * words / rate * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "operations" if ops_ms > bytes_ms else "bytes"
        family, rounds = parse_rng_mode(mode)
        if family == "hw":
            family, rounds = "philox", 10
        out[mode] = {}
        for var, fn in FUSED.items():
            max_err = max(max_err, fused_against(
                f"{fn.__name__} != plain at {MAIN_SHAPE}^2 {mode}",
                fn(b, w, thr, 0, 1, **kw), ref))
            cases += 1
            timed = {band: median_ms(lambda i, band=band: fn(
                b, w, thr, 0, i, band_rows=band, **kw))
                for band in (None, FUSED_TIMED_BAND)}
            (ms, runs), (other_ms, _) = timed[None], timed[FUSED_TIMED_BAND]
            band = packed.fused_band_rows(H, W, mode, manual=var == "2")
            pipes = dict((loops or {}).get(("packed_fused", (
                bit1._FAMILY_CODE[family], rounds, packed.ACCEPT_METROPOLIS,
                int(var == "2"))), {}))
            per_word = {p: pipes[p] / (2 if family == "chacha" else 1)
                        for p in ("alu", "fma") if p in pipes}
            out[mode][var] = {
                "ms": ms, "ms_runs": runs, "band_rows": band,
                "other_band_rows": FUSED_TIMED_BAND, "other_band_ms": other_ms,
                "two_sweeps_ms": two_ms, "two_sweeps_runs": two_runs,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bytes_ms": bytes_ms,
                "ops_per_word": ops, "ops_ms": ops_ms, "sass_per_pass": pipes,
                "sass_per_word": per_word}
            say(f"[timing] {MAIN_SHAPE}^2 {fn.__name__} {mode}, one step: "
                f"{ms:.4f} ms median of {TIMED_REPEATS} x {TIMED_LAUNCHES} "
                f"(range {runs[0]:.4f}-{runs[-1]:.4f}; "
                f"{2 * words * packed.FIELDS / ms / 1e6:.1f} flips/ns) at "
                f"its default band of {band} rows, {other_ms:.4f} ms at "
                f"{FUSED_TIMED_BAND} rows; two packed_sweep launches "
                f"{two_ms:.4f} ms ({ms / two_ms:.3f}x); plain {plain_ms:.2f} "
                f"ms; bound {bound_ms:.4f} ms by {bound_by} (bytes "
                f"{bytes_ms:.4f} ms; {ops:.1f} integer ops/word -> "
                f"{ops_ms:.4f} ms), {bound_ms / ms:.1%} of bound; compiled "
                f"code per pass of its loop {pipes}; "
                + ", ".join(f"{p.upper()} {n:.2f}" for p, n in per_word.items())
                + f" instructions a word, on {card['smi']}")
    return out, cases, max_err


def fused_entry(var, main_path, timing, cases, max_err, info):
    """The kernels line's entry of one fused kernel: launches of its own
    main-path runs, its per-step timing in threefry13 (every mode under
    per_mode)."""
    fn = FUSED[var]
    t = timing["threefry13"][var]
    runs = {f"{what} {mode}": r for (v, what, mode), r in main_path.items()
            if v == var and r["kernel"] == fn.__name__}
    return {
        "name": fn.__name__,
        "route": "cuda",
        "source": "ising_tpu_torch/csrc/packed_fused.cu",
        "sources": [f"ising_tpu_torch/csrc/{n}" for n in (
            "packed_fused.cu", "packed_word.cuh", "counter_rng.cuh")],
        "replaces": FUSED_KERNEL[var],
        "path": f"ISING_TPU_FUSED={var}",
        "launches": sum(r["launches"] for r in runs.values()),
        "main_path": runs,
        "max_abs_err": max_err,
        "compared_cases": cases,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "held_against_plain": True,
        "build_s": info.seconds,
        "per_mode": {m: v[var] for m, v in timing.items()},
    }


BIT1_KERNEL = {"source": "ising_tpu_torch/csrc/bit1_sweep.cu",
               "replaces": "ising_tpu/ops/pallas_bit1.py:265"}
PACKED_KERNEL = {"source": "ising_tpu_torch/csrc/packed_sweep.cu",
                 "replaces": "ising_tpu/ops/pallas_packed.py:396"}
DENSE_KERNEL = {"source": "ising_tpu_torch/csrc/dense_sweep.cu",
                "replaces": "ising_tpu/ops/pallas_dense.py:145"}
MXU_KERNEL = {"source": "ising_tpu_torch/csrc/mxu_sweep.cu",
              "replaces": "ising_tpu/ops/mxu.py:71"}


def kernel_entry(name, path, timing, launches, main_path, max_err, info,
                 kernel=BIT1_KERNEL):
    """One entry of the kernels line: the timing of `path` in the first
    mode its main-path runs used (threefry13 where it has none)."""
    t = timing[(next(iter(main_path), "threefry13"), 0.0, path)]
    return {
        "name": name,
        "route": "cuda",
        "source": kernel["source"],
        "sources": [f"ising_tpu_torch/csrc/{p.name}" for p in
                    sorted(kernel_lib.CSRC_DIR.glob("*.cu*"))],
        "replaces": kernel["replaces"],
        "path": path or "ordered",
        "launches": launches,
        "main_path": main_path,
        "max_abs_err": max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "held_against_plain": True,
        "build_s": info.seconds,
        "per_mode": {f"{m}" + (f" h={f}" if f else ""): v
                     for (m, f, p), v in timing.items() if p == path},
    }


def plane_kernel_entry(name, kernel, path, timing, launches, main_path,
                       max_err, info):
    """One entry of the kernels line for dense_sweep or mxu_sweep: the
    timing of `path` at 16384^2 in the first main-path mode, with every
    timed mode at both shapes under per_mode."""
    t = timing[(kernel, PLANE_MAIN_MODES[0], 0.0, path, MAIN_SHAPE)]
    src = DENSE_KERNEL if kernel == "dense" else MXU_KERNEL
    return {
        "name": name,
        "route": "cuda",
        "source": src["source"],
        "sources": [src["source"], "ising_tpu_torch/csrc/site_draws.cuh",
                    "ising_tpu_torch/csrc/counter_rng.cuh"],
        "replaces": src["replaces"],
        "path": path or "ordered",
        "launches": launches,
        "main_path": {f"{k[0]}^2 {k[1]}" if isinstance(k, tuple) else k: v
                      for k, v in main_path.items()},
        "max_abs_err": max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "held_against_plain": True,
        "build_s": info.seconds,
        "per_mode": {f"{s}^2 {m}" + (f" h={f}" if f else ""): v
                     for (k, m, f, p, s), v in timing.items()
                     if k == kernel and p == path},
    }


def random_bonds(gen, Y, X, p, device):
    return tuple(torch.from_numpy(gen.random((Y, X)) < p).to(device)
                 for _ in range(2))


def snake_bonds(Y, X, device):
    """One cluster that snakes through every tile: rows open along their
    length but for the periodic wrap, joined at alternate ends (the longest
    chain of tile roots the hooks can meet)."""
    o_r = torch.ones((Y, X), dtype=torch.bool, device=device)
    o_r[:, -1] = False
    o_d = torch.zeros_like(o_r)
    o_d[0:Y - 1:2, -1] = True
    o_d[1:Y - 1:2, 0] = True
    return o_r, o_d


def max_err(a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def phase_compare_labels(dev):
    """The labeler's kernels against their plain versions, bit for bit, at
    the tile pick_tile gives each case of LABEL_CASES, on bonds open at
    every probability of LABEL_PROBS (and a cluster that snakes through
    every tile on the full lattices): tile_roots against
    tile_roots_reference (positions, and the ids where tiles hold whole
    replicas); hook_roots and flatten_roots from that plane against the
    plain hook and flatten, which equal label_clusters (the hooks' forest
    depends on the order of the atomics, the flattened labels do not); the
    whole labeling against label_clusters, with its launches. Returns
    (cases, max abs err)."""
    gen = np.random.default_rng(2026)
    cases, worst = 0, 0
    for Y, X, ysl, xsl in LABEL_CASES:
        geo = dict(ysl=ysl, xsl=xsl)
        tile = cluster.pick_tile(Y, X, **geo)
        whole = cluster.whole_replica_tiles((Y, X), tile, **geo)
        bonds = [(p, random_bonds(gen, Y, X, p, dev)) for p in LABEL_PROBS]
        if ysl is None:
            bonds.append(("snake", snake_bonds(Y, X, dev)))
        launches = set()
        for p, (o_r, o_d) in bonds:
            where = f"{Y}x{X} replicas {ysl}x{xsl} tile {tile} p={p}"
            want = cluster.label_clusters(o_r, o_d, **geo)
            parent = torch.empty((Y, X), dtype=torch.int32, device=dev)
            for ids in (False, True) if whole else (False,):
                cluster.tile_roots(o_r, o_d, parent, tile=tile, ids=ids, **geo)
                ref = cluster.tile_roots_reference(o_r, o_d, tile=tile,
                                                   ids=ids, **geo)
                torch.cuda.synchronize()
                worst = max(worst, max_err(parent, ref))
                require(torch.equal(parent, ref),
                        f"tile_roots != plain at {where} ids={ids}")
                cases += 1
            if not whole:
                cluster.tile_roots(o_r, o_d, parent, tile=tile, **geo)
                labels = (parent if ysl is None
                          else torch.empty_like(parent))
                cluster.hook_roots(o_r, o_d, parent, tile=tile, **geo)
                cluster.flatten_roots(parent, labels, tile=tile, **geo)
                ref = cluster.flatten_reference(cluster.hook_reference(
                    cluster.tile_roots_reference(o_r, o_d, tile=tile, **geo),
                    o_r, o_d, tile=tile, **geo), **geo)
                torch.cuda.synchronize()
                worst = max(worst, max_err(labels, ref))
                require(torch.equal(labels, ref) and torch.equal(ref, want),
                        f"hook_roots + flatten_roots != plain at {where}")
                cases += 1
            got, stats = cluster.label_clusters_tiled(o_r, o_d,
                                                      return_stats=True, **geo)
            torch.cuda.synchronize()
            worst = max(worst, max_err(got, want))
            require(torch.equal(got, want)
                    and stats["launches"] == (1 if whole else 3),
                    f"label_clusters_tiled != label_clusters at {where} "
                    f"({stats})")
            cases += 1
            launches.add(stats["launches"])
        say(f"[label] {Y}x{X} replicas {ysl}x{xsl}, tile {tile}: "
            f"tile_roots{' (positions and ids)' if whole else ''} equal to "
            f"its plain version"
            + ("" if whole else ", hook_roots + flatten_roots equal to the "
               "plain hook and flatten")
            + ", labelings equal to label_clusters at p = "
            + ", ".join(str(p) for p, _ in bonds)
            + f" ({', '.join(map(str, sorted(launches)))} launches a "
              "labeling)")
    return cases, worst


def phase_sw_golden():
    for case, want in golden.SW_GOLDEN.items():
        got = golden.port_sw_trajectory(*case, device="cuda")
        require(got == want, f"SW golden {case}: got {got}, want {want}")
        say(f"[golden] SW {golden.SW_NROWS}x{golden.SW_NCOLS} {case}: up "
            f"counts {got['up']} and crc32 {got['crc32']:08X} match the JAX "
            "package")


def sw_runs(card, what, extra, runs, shape=SW_SHAPE, iters=SW_ITERS,
            prints=SW_PRINT, e_max=-1.2):
    """`runs` CLI runs of --algo sw at shape^2, T = Tc, with the flags
    `extra`: set-up timed, peak memory read, every launch count set to 0
    just before the run loop and read after it: tile_roots once an update,
    hook_roots and flatten_roots once an update that takes three launches,
    their sum the launches the run counted, each kernel of the path
    launched, the sweeps not. E/N must lie in (-2.2, e_max)."""
    rates = []
    launches = {f.__name__: 0 for f in cluster.LABEL_PHASES}
    for _ in range(runs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sim = cli_simulation(SW_FLAGS + ["-x", str(shape), "-y", str(shape),
                                         "-n", str(iters), "-p", str(prints)]
                             + extra)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        require(isinstance(sim, cluster.SwendsenWang), "not a SwendsenWang")
        for f in COUNTERS:
            f.launches = 0
        result = sim.run()
        n = {f.__name__: f.launches for f in cluster.LABEL_PHASES}
        updates = sum(sim.launch_counts.values())
        three = sim.launch_counts[3]
        require(result["steps"] == iters == updates,
                f"ran {result['steps']} of {iters} updates ({updates} "
                "labelings)")
        require(n["tile_roots"] == updates
                and n["hook_roots"] == n["flatten_roots"] == three
                and sum(n.values()) == sum(k * v for k, v in
                                           sim.launch_counts.items()),
                f"labeler launches {n}, the run counted "
                f"{dict(sim.launch_counts)}")
        require(n["tile_roots"] > 0 and (n["hook_roots"] > 0) == (three > 0),
                f"a kernel of the SW path was not launched: {n}")
        require(not any(f.launches for f in SWEEPS.values()),
                "a Metropolis kernel launched on the SW path")
        e_n = sim.energy()
        m = result["magnetization"]
        require(math.isfinite(e_n) and -2.2 < e_n < e_max and 0 <= m <= 1,
                f"E/N = {e_n}, |m| = {m} after the SW {what} run")
        if sim.cfg.xsl is not None:
            rm = sim.replica_magnetizations()
            count = (shape // sim.cfg.xsl) * (shape // sim.cfg.ysl)
            require(rm.shape == (count,) and np.all((rm >= 0) & (rm <= 1)),
                    f"replica |m| of shape {rm.shape}")
            say(f"[sw] {count} replica |m|: mean {rm.mean():.6f}, range "
                f"{rm.min():.6f}-{rm.max():.6f}")
        for k, v in n.items():
            launches[k] += v
        rates.append(result["flips_ns"])
        say(f"[sw] {shape}^2 {what}: launches {n} over {updates} updates "
            f"({dict(sim.launch_counts)} by launches an update), no host "
            f"read in a labeling; E/N {e_n:.6f}, |m| {m:.6f}, "
            f"{result['flips_ns']:.4f} flips/ns; set-up {setup:.3f} s, peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
            f"GiB on {card['smi']}")
        last = sim
        del sim
        torch.cuda.empty_cache()
    median = sorted(rates)[len(rates) // 2]
    say(f"[sw] {shape}^2 {what}: {median:.4f} flips/ns median of {runs} "
        f"runs (range {min(rates):.4f}-{max(rates):.4f})")
    return {"launches": launches, "flips_ns": median, "flips_ns_runs": rates,
            "launches_per_update": dict(last.launch_counts),
            "full": last.full}


def phase_sw_main(card):
    """The README's --algo sw runs (SW_RUNS), the 16384^2 run, and at
    256^2 the card's lattice and launches after SW_EQUALITY_ITERS updates
    against the CPU's (the plain path)."""
    out = {what: sw_runs(card, what, extra, runs)
           for what, extra, runs in SW_RUNS}
    # 4 updates from the random start: E/N about -1.16 (256^2, CPU)
    out["scale"] = sw_runs(card, "scale", [], 1, SW_SCALE_SHAPE,
                           SW_SCALE_ITERS, SW_SCALE_ITERS, -0.9)
    flags = SW_FLAGS + ["-x", str(SW_EQUALITY_SHAPE), "-y",
                        str(SW_EQUALITY_SHAPE)]
    for extra in ([], ["--field", "0.1"], ["--xsl", "64", "--ysl", "32"],
                  ["--xsl", "256", "--ysl", "128"]):
        sims = [cli_simulation(flags + extra + dev)
                for dev in ([], ["--device", "cpu"])]
        for sim in sims:
            sim.advance(SW_EQUALITY_ITERS)
        require(torch.equal(sims[0].full.cpu(), sims[1].full)
                and sims[0].launch_counts == sims[1].launch_counts,
                f"SW at {SW_EQUALITY_SHAPE}^2 {' '.join(extra)}: the card's "
                "run differs from the CPU's")
        say(f"[sw] {SW_EQUALITY_SHAPE}^2 {' '.join(extra)}: lattice after "
            f"{SW_EQUALITY_ITERS} updates and launches "
            f"{dict(sims[0].launch_counts)} equal to the CPU's")
    return out


def io_cli(directory: Path, argv, kernel, steps: int):
    """cli.main(argv) run in `directory` (where -o and -c write), every
    launch count set to 0 just before and read just after: `kernel` must
    launch twice a step for `steps` steps, and nothing else launch."""
    for f in COUNTERS:
        f.launches = 0
    with contextlib.chdir(directory):
        code = cli.main(argv)
    require(code == 0, f"the CLI exited {code} on {argv}")
    require(kernel.launches == 2 * steps,
            f"{kernel.__name__} launched {kernel.launches} times on {argv}, "
            f"expected {2 * steps}")
    require(not any(f.launches for f in COUNTERS if f is not kernel),
            f"another kernel launched on {argv}")
    return kernel.launches


def corr_lines(directory: Path) -> dict:
    """{iteration: the rest of its line} of the one corr_* file there."""
    paths = list(directory.glob("corr_*"))
    require(len(paths) == 1, f"{len(paths)} corr_* files in {directory}")
    lines = paths[0].read_text().splitlines()
    return {int(ln[:10]): ln[10:] for ln in lines}


def same_file(a: Path, b: Path, what: str):
    require(a.read_bytes() == b.read_bytes(), f"{what}: {a} != {b}")


def ck_body(path: Path) -> bytes:
    from ising_tpu_torch.checkpoint import read_checkpoint_meta
    return path.read_bytes()[read_checkpoint_meta(path)["_body_offset"]:]


def sync_s(fn):
    """(result, seconds) of fn() ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_io(card):
    """The output files on the card, written into a temporary directory
    that is removed. Resume equals uninterrupted: the CLI's IO_FLAGS run with --checkpoint
    A, then --resume A --checkpoint B, against one straight run to the
    same step: B's body equals the straight run's, the final dumps are
    equal, and the -c lines and dumps of the shared iterations. The bit1
    checkpoint resumed on packed and on dense continues to the same
    files. On the same words, bit1's word-domain paths equal the decode
    paths. The IO goldens written on the card match the JAX package's
    checksums. Prints the times of a -c measurement (bit1, dense), a
    checkpoint save and resume, and a dump with its size."""
    from ising_tpu_torch.checkpoint import (_chunk_schedule, _pack_rows,
                                            _unpack_rows_device)
    from ising_tpu_torch.driver import Simulation
    with tempfile.TemporaryDirectory() as tmp:
        d = {k: Path(tmp) / k for k in ("A", "B", "S", "packed", "dense", "g")}
        for p in d.values():
            p.mkdir()
        ck = {k: d[k] / "run.ck" for k in ("A", "B", "S")}
        n = io_cli(d["A"], IO_FLAGS + ["-n", str(IO_ITERS), "--checkpoint",
                                       str(ck["A"])],
                   bit1.bit1_sweep, IO_WARMUP + IO_ITERS)
        n += io_cli(d["B"], ["--resume", str(ck["A"]), "--checkpoint",
                             str(ck["B"])],
                    bit1.bit1_sweep, IO_WARMUP + IO_ITERS)
        n += io_cli(d["S"], IO_FLAGS + ["-n", str(IO_STRAIGHT_ITERS),
                                        "--checkpoint", str(ck["S"])],
                    bit1.bit1_sweep, IO_WARMUP + IO_STRAIGHT_ITERS)
        require(ck_body(ck["B"]) == ck_body(ck["S"]),
                "the resumed run's checkpoint body differs from the straight "
                "run's")
        final = f"final_{MAIN_SHAPE}x{MAIN_SHAPE}.txt"
        same_file(d["B"] / final, d["S"] / final, "final dump")
        dump = lambda it: (f"lattice_{MAIN_SHAPE}x{MAIN_SHAPE}_T_1.500000_"
                           f"IT_{it:08d}.txt")
        same_file(d["A"] / dump(IO_PRINT), d["S"] / dump(IO_PRINT),
                  "dump of the first run's measurement")
        same_file(d["B"] / dump(IO_PRINT), d["S"] / dump(IO_STRAIGHT_ITERS),
                  "dump of the last step")
        a, b, s = (corr_lines(d[k]) for k in "ABS")
        require(a[IO_PRINT] == s[IO_PRINT]
                and b[IO_PRINT] == s[IO_STRAIGHT_ITERS],
                "-c lines differ from the straight run's")
        say(f"[io] {MAIN_SHAPE}^2 bit1 {IO_MODE}: -w {IO_WARMUP} -n "
            f"{IO_ITERS} --checkpoint, then --resume: checkpoint body, final "
            f"dump, dumps and -c lines equal to one run of -n "
            f"{IO_STRAIGHT_ITERS}; bit1_sweep launches {n}")
        resumed = {}
        for be in IO_RESUME_BACKENDS:
            sim = resumed[be] = Simulation.from_checkpoint(
                str(ck["A"]), backend=be, device="cuda")
            for f in COUNTERS:
                f.launches = 0
            with contextlib.chdir(d[be]):
                sim.run()
                sim.dump(final)
            kernel = SWEEPS[be]
            require(kernel.launches == 2 * (IO_WARMUP + IO_ITERS)
                    and not any(f.launches for f in COUNTERS
                                if f is not kernel),
                    f"{be} resume: {kernel.__name__} launched "
                    f"{kernel.launches} times")
            same_file(d[be] / final, d["B"] / final, f"{be} resume")
            same_file(d[be] / dump(IO_PRINT), d["B"] / dump(IO_PRINT),
                      f"{be} resume's dump")
            require(corr_lines(d[be]) == b, f"{be} resume's -c lines")
            say(f"[io] bit1 checkpoint resumed on {be}: final dump, dump "
                f"and -c line equal to bit1's continuation; "
                f"{kernel.__name__} launches {kernel.launches}")
        for k in "ABS":
            for p in d[k].glob("*.txt"):
                p.unlink()
        # bit1's word-domain paths against the decode paths, on one state
        sim, t_resume = sync_s(lambda: Simulation.from_checkpoint(
            str(ck["B"]), device="cuda"))
        be, bw, ww = sim.backend, sim.black, sim.white
        ch = MAIN_SHAPE // 2
        for r0, r1 in _chunk_schedule(MAIN_SHAPE, 8192)[0]:
            pb, pw = (p.cpu().numpy()
                      for p in be.pack_storage_rows(bw, ww, r0, r1))
            db, dw = be.decode(bw[r0:r1], ww[r0:r1])
            require(np.array_equal(pb, _pack_rows(db))
                    and np.array_equal(pw, _pack_rows(dw)),
                    f"pack_storage_rows != packed decode at rows {r0}-{r1}")
            eb, ew = be.encode_packed_rows(pb, pw)
            ub, uw = be.encode(_unpack_rows_device(pb, ch, "cuda"),
                               _unpack_rows_device(pw, ch, "cuda"))
            require(torch.equal(eb, ub) and torch.equal(ew, uw)
                    and torch.equal(eb, bw[r0:r1])
                    and torch.equal(ew, ww[r0:r1]),
                    f"encode_packed_rows != encode of the unpacked bytes at "
                    f"rows {r0}-{r1}")
        words, t_words = sync_s(lambda: be.corr_rows(bw, ww, MAX_CORR_LEN))
        via, t_via = sync_s(lambda: observables.correlation_rows_via(
            sim._decode_rows, MAIN_SHAPE, MAX_CORR_LEN))
        require(torch.equal(words, via), "corr_rows != correlation_rows_via "
                "over decoded rows")
        say(f"[io] {MAIN_SHAPE}^2 bit1: pack_storage_rows, encode_packed_rows "
            f"and corr_rows ({tuple(words.shape)} int64 row sums) equal to "
            f"the decode paths on the card")
        # the times, at 16384^2
        with contextlib.chdir(d["g"]):
            t_corr = [sync_s(lambda: sim._append_corr(0))[1]
                      for _ in range(2)]
            t_dense = [sync_s(lambda: resumed["dense"]._append_corr(0))[1]
                       for _ in range(2)]
            t_save = [sync_s(lambda: sim.checkpoint("t.ck"))[1]
                      for _ in range(2)]
            t_dump = [sync_s(lambda: sim.dump("t.txt"))[1]
                      for _ in range(2)]
            size = os.path.getsize("t.txt")
            os.unlink("t.txt")
        say(f"[io] {MAIN_SHAPE}^2 times on {card['smi']}: one -c measurement "
            f"bit1 (words) {t_corr[0]:.4f}, {t_corr[1]:.4f} s, dense "
            f"(decode path) {t_dense[0]:.4f}, {t_dense[1]:.4f} s; "
            f"corr_rows alone {t_words:.4f} s, correlation_rows_via on bit1 "
            f"{t_via:.4f} s; checkpoint save {t_save[0]:.4f}, "
            f"{t_save[1]:.4f} s ({os.path.getsize(ck['B'])} bytes), resume "
            f"(from_checkpoint) {t_resume:.4f} s; hex dump {t_dump[0]:.4f}, "
            f"{t_dump[1]:.4f} s, {size} bytes")
        del sim, resumed
        torch.cuda.empty_cache()
        for i, (case, want) in enumerate(golden.IO_GOLDEN.items()):
            (d["g"] / str(i)).mkdir()
            got = golden.port_io_files(case, d["g"] / str(i), device="cuda")
            require(got == want, f"IO golden {case}: got {got}, want {want}")
            say(f"[io] golden {case}: -c line, dump and checkpoint crc32 "
                + ", ".join(f"{k} {v:08X}" for k, v in got.items())
                + " match the JAX package's files")


def pt_lines(text: str) -> list:
    """The --pt output lines that the JAX CLI's must equal: each rung's
    T / magnetization / E/N line, the acceptance and round-trip lines."""
    return [ln for ln in text.splitlines()
            if "T = " in ln or ln.startswith(("Pair acceptance",
                                              "Completed round trips"))]


def pt_cli(argv):
    """(stdout, seconds, launches by kernel) of cli.main(argv), every launch
    count set to 0 just before and read just after."""
    for f in COUNTERS:
        f.launches = 0
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    require(code == 0, f"the CLI exited {code} on {argv}")
    return out.getvalue(), seconds, {f.__name__: f.launches
                                     for f in COUNTERS if f.launches}


def pt_records(pt):
    m = pt.measure()
    return (tuple(r["hamiltonian"] for r in m), tuple(r["up"] for r in m),
            tuple(pt.accepts), tuple(pt.replica_at))


def phase_pt(card):
    """Parallel tempering on the card. (a) The README's --pt command on
    xla, bit1 and packed: the per-rung, acceptance and round-trip lines
    equal, bit1_sweep's and packed_sweep's launches counted. (b) The PT
    golden (golden.PT_GOLDEN) on bit1, packed and dense. (c) At
    bench_pt.py's ladder, batched rounds against per-rung rounds: H, up
    counts, accepts and replica_at equal round by round; one rung's sweeps
    and both rounds timed. (d) At 16384^2 on bit1, the Fourier partials
    and the overlap of two seeds on the words against the decode path,
    and on packed's words and across backends, each timed."""
    from ising_tpu_torch.driver import Simulation
    from ising_tpu_torch.tempering import ParallelTempering
    lines = {}
    for be in PT_BACKENDS:
        out, seconds, launches = pt_cli(PT_FLAGS + ["--backend", be])
        lines[be] = pt_lines(out)
        want = {} if be == "xla" else {SWEEPS[be].__name__: PT_LAUNCHES}
        require(launches == want, f"--pt on {be}: launches {launches}, "
                f"expected {want}")
        require(len(lines[be]) == 4 * 4 + 2, f"--pt on {be}: "
                f"{len(lines[be])} result lines")
        say(f"[pt] README --pt on {be}: {seconds:.3f} s, launches "
            f"{launches or 'none (plain torch)'}; {lines[be][-2]}; "
            f"{lines[be][-1]}")
    require(lines["bit1"] == lines["xla"] and lines["packed"] == lines["xla"],
            "--pt lines differ across backends")
    say(f"[pt] README --pt: the {len(lines['xla'])} T / magnetization / E/N,"
        f" acceptance and round-trip lines equal on "
        f"{', '.join(PT_BACKENDS)}")
    for be in PT_GOLDEN_BACKENDS:
        for f in COUNTERS:
            f.launches = 0
        got = golden.port_pt_record(be, device="cuda")
        n = SWEEPS[be].launches
        want_n = 2 * len(golden.PT_TEMPS) * golden.PT_SWEEPS * 2 * \
            golden.PT_ROUNDS
        require(got == golden.PT_GOLDEN, f"PT golden on {be}: got {got}")
        require(n == want_n, f"PT golden on {be}: {SWEEPS[be].__name__} "
                f"launched {n} times, expected {want_n}")
        say(f"[pt] golden PT_GOLDEN reproduced on {be}: accepts "
            f"{got['accepts']}, replica_at {got['replica_at']}, crc32 "
            + ", ".join(f"{c:08X}" for c in got["crc32"])
            + f"; {SWEEPS[be].__name__} launches {n}")
    # (c) batched against per-rung at bench_pt.py's ladder
    K = PT_BENCH_RUNGS
    r = (PT_BENCH_TEMPS[1] / PT_BENCH_TEMPS[0]) ** (1.0 / (K - 1))
    temps = [PT_BENCH_TEMPS[0] * r ** i for i in range(K)]
    cfg = SimConfig(nrows=PT_BENCH_SIZE, ncols=PT_BENCH_SIZE, temp=temps[0],
                    seed=PT_BENCH_SEED, backend="packed", rng="threefry13",
                    device="cuda")
    sim = Simulation(cfg)
    t_rung = event_ms(lambda: sim.advance(PT_BENCH_SWEEPS), 10)
    del sim
    pts = [ParallelTempering(cfg, temps, sweeps_per_swap=PT_BENCH_SWEEPS,
                             batched=b) for b in (True, False)]
    t_round = [[], []]
    for _ in range(PT_BENCH_ROUNDS):
        for i, pt in enumerate(pts):
            t_round[i].append(host_ms(pt.advance_round))
        require(pt_records(pts[0]) == pt_records(pts[1]),
                f"batched and per-rung records differ at round {pts[0].round}"
                f": {pt_records(pts[0])} against {pt_records(pts[1])}")
    med = [sorted(t[1:])[len(t) // 2 - 1] for t in t_round]
    m = pts[0].measure()
    require(all(math.isfinite(x["energy"]) and -2 <= x["energy"] <= 0
                for x in m), f"E/N out of range: {m}")
    say(f"[pt] bench_pt ladder, {K} rungs at {PT_BENCH_SIZE}^2 packed "
        f"threefry13, {PT_BENCH_SWEEPS} sweeps a swap: H, up counts, "
        f"accepts {pts[0].accepts} and replica_at equal batched and per "
        f"rung over {PT_BENCH_ROUNDS} rounds; one rung's sweeps "
        f"{t_rung:.4f} ms (CUDA events), a batched round {med[0]:.3f} ms, a "
        f"per-rung round {med[1]:.3f} ms (host clock, median of rounds 2-"
        f"{PT_BENCH_ROUNDS}; all: {[round(x, 3) for x in t_round[0]]}, "
        f"{[round(x, 3) for x in t_round[1]]}); E/N of the coldest rung "
        f"{m[0]['energy']:.6f} on {card['smi']}")
    del pts
    torch.cuda.empty_cache()
    # (d) the word paths against the decode paths at 16384^2
    sims = {}
    for be in ("bit1", "packed"):
        for seed in (1, 2):
            s = sims[be, seed] = Simulation(SimConfig(
                nrows=MAIN_SHAPE, ncols=MAIN_SHAPE, temp=1.5, seed=seed,
                backend=be, rng=PT_WORDS_MODE, device="cuda"))
            s.advance(PT_WORDS_STEPS)
    a, b = sims["bit1", 1], sims["bit1", 2]
    t = {}
    (rows, cols), t["fourier words"] = sync_s(a.fourier_partials)
    (via_rows, via_cols), t["fourier decode"] = sync_s(lambda: (
        observables.row_up_counts(*a.bits()).cpu().numpy(),
        observables.col_up_counts_via(a._decode_rows,
                                      MAIN_SHAPE).cpu().numpy()))
    require(np.array_equal(rows, via_rows) and np.array_equal(cols, via_cols),
            "fourier_partials on bit1's words != the decode path")
    require(int(rows.sum()) == int(cols.sum()) == a.measure()["up"],
            "row and column up counts do not sum to the up count")
    say(f"[pt] {MAIN_SHAPE}^2 bit1 {PT_WORDS_MODE} after {PT_WORDS_STEPS} "
        f"steps: fourier_partials on the words ({rows.size} row and "
        f"{cols.size} column counts) equal the decode path "
        f"(col_up_counts_via over _decode_rows)")
    q, neq = {}, {}
    (neq["bit1 words"], t["overlap bit1 words"]) = sync_s(
        lambda: a._overlap_neq_rows_with(b))
    (neq["packed words"], t["overlap packed words"]) = sync_s(
        lambda: sims["packed", 1]._overlap_neq_rows_with(sims["packed", 2]))
    (neq["decode"], t["overlap decode"]) = sync_s(
        lambda: observables.overlap_neq_rows_via(a._decode_rows,
                                                 b._decode_rows, MAIN_SHAPE))
    neq["bit1 against packed"] = a._overlap_neq_rows_with(sims["packed", 2])
    for k, v in neq.items():
        require(torch.equal(v, neq["decode"]), f"overlap neq rows: {k} "
                "!= the decode path")
        q[k] = 1.0 - 2.0 * int(v.sum()) / (MAIN_SHAPE * MAIN_SHAPE)
    require(len(set(q.values())) == 1 and q["bit1 words"] == a.overlap_with(b)
            and a.overlap_with(sims["packed", 1]) == 1.0,
            f"overlaps differ: {q}")
    say(f"[pt] {MAIN_SHAPE}^2 overlap of seeds 1 and 2 after "
        f"{PT_WORDS_STEPS} steps: q = {q['decode']!r} on bit1's words, "
        f"packed's words, the decode path and bit1 against packed; a bit1 "
        f"state against its packed twin q = 1.0")
    say(f"[pt] {MAIN_SHAPE}^2 times on {card['smi']} (host clock around a "
        f"synchronize, ms): " + ", ".join(f"{k} {v * 1e3:.3f}"
                                          for k, v in t.items()))
    del sims, a, b
    torch.cuda.empty_cache()


def slab_launches():
    """{wrapper name: launches} of every counted wrapper that launched."""
    return {f.__name__: f.launches for f in COUNTERS if f.launches}


def multi_route(backend: str, extra: dict) -> str:
    """The kernels line's entry of a sharded run's sweeps: the J-plane path
    of bit1 (split links are the one-device path) and dense, packed's J
    word, the replica paths, else the backend's ordered entry."""
    name = f"{backend}_sweep"
    if extra.get("j_prob") is not None:
        return name + ("[jword]" if backend == "packed" else "[jplanes]")
    if extra.get("xsl") is not None:
        return name + "[replicas]"
    return name


def same_state(sim, one) -> bool:
    """The slabs of sim, joined, equal one's one-device storage."""
    return (torch.equal(gather_rows(sim.black), one.black)
            and torch.equal(gather_rows(sim.white), one.white))


def multi_case(mesh_of, where, name, backend, rng, extra, slabs, launches):
    """One of MULTI_CASES: MULTI_STEPS steps at MAIN_SHAPE^2 on one device,
    then over each slab count n of `slabs` on mesh_of(n): every
    count set to 0 just before the sharded run's steps and read after
    (the backend's sweep, 2 a slab a step or 6 with halo_overlap, and no
    other kernel), its storage, up counts and bond sum equal to the
    one-device run's."""
    from ising_tpu_torch.driver import Simulation
    base = dict(nrows=MAIN_SHAPE, ncols=MAIN_SHAPE, temp=1.5, backend=backend,
                rng=rng, **extra)
    one = Simulation(SimConfig(**{k: v for k, v in base.items()
                                  if k != "halo_overlap"}))
    one.advance(MULTI_STEPS)
    want = (one.measure(), one.energy_total())
    kernel = SWEEPS[backend].__name__
    route = multi_route(backend, extra)
    for n in slabs:
        sim = Simulation(SimConfig(ndev=n, **base), mesh=mesh_of(n))
        per_slab = 6 if extra.get("halo_overlap") else 2
        for f in COUNTERS:
            f.launches = 0
        sim.advance(MULTI_STEPS)
        torch.cuda.synchronize()
        got = slab_launches()
        require(got == {kernel: per_slab * n * MULTI_STEPS},
                f"[multi] {name} over {n} slabs launched {got}, expected "
                f"{per_slab * n * MULTI_STEPS} of {kernel} alone")
        launches[route] += got[kernel]
        require(same_state(sim, one), f"[multi] {name} ({backend} {rng} "
                f"{extra}): the {n}-slab state differs from one device's")
        require((sim.measure(), sim.energy_total()) == want,
                f"[multi] {name} over {n} slabs: up counts or bond sum "
                f"{(sim.measure(), sim.energy_total())} != {want}")
        say(f"[multi] {name}: {MAIN_SHAPE}^2 {backend} {rng} "
            f"{' '.join(f'{k}={v}' for k, v in extra.items())} over {n} "
            f"slabs {where}: {kernel} launched {got[kernel]} "
            f"(= {per_slab} x {n} x {MULTI_STEPS} steps), state, up counts "
            f"and bond sum bit-identical to one device "
            f"(|m| = {want[0]['magnetization']:.6f}, bond sum {want[1]})")
        del sim
    del one
    torch.cuda.empty_cache()


def multi_files(mesh_of, where, tmp: Path, launches):
    """The checkpoint case of MULTICHIP_r05.json and the per-shard dumps:
    MAIN_SHAPE^2 bit1 philox saved at one slab after 2 steps, resumed at
    4 slabs for 2 more (bit1_sweep's launches counted) equals 4 steps on
    one device, and saved again at 4 slabs writes the one-device
    checkpoint's body (the header's config holds ndev); at
    MULTI_DUMP_SHAPE^2 the 4 per-shard dumps,
    joined, are the one-device dump's bytes."""
    from ising_tpu_torch.driver import Simulation
    cfg = SimConfig(nrows=MAIN_SHAPE, ncols=MAIN_SHAPE, temp=1.5,
                    backend="bit1", rng="philox")
    ref = Simulation(cfg)
    ref.advance(4)
    half = Simulation(cfg)
    half.advance(2)
    half.checkpoint(str(tmp / "half.ck"))
    resumed = Simulation.from_checkpoint(str(tmp / "half.ck"), ndev=4,
                                         mesh=mesh_of(4),
                                         device=mesh_of(4)[0].type)
    require(resumed.step == 2 and resumed.cfg.ndev == 4
            and isinstance(resumed.black, list),
            f"[multi] resume at 4 slabs: step {resumed.step}, ndev "
            f"{resumed.cfg.ndev}")
    for f in COUNTERS:
        f.launches = 0
    resumed.advance(2)
    torch.cuda.synchronize()
    got = slab_launches()
    require(got == {"bit1_sweep": 2 * 4 * 2},
            f"[multi] resumed run launched {got}")
    launches["bit1_sweep"] += got["bit1_sweep"]
    require(same_state(resumed, ref), "[multi] ckpt_resume: the run saved at "
            "1 slab and resumed at 4 differs from 4 steps on one device")
    ref.checkpoint(str(tmp / "one.ck"))
    resumed.checkpoint(str(tmp / "four.ck"))
    require(ck_body(tmp / "one.ck") == ck_body(tmp / "four.ck"),
            "[multi] the 4-slab checkpoint's body differs from one device's")
    say(f"[multi] ckpt_resume: {MAIN_SHAPE}^2 bit1 philox saved at 1 slab, "
        f"resumed at 4 {where}: continuation bit-identical, "
        f"bit1_sweep launched {got['bit1_sweep']}; the body of its checkpoint "
        f"saved at 4 slabs equals one device's "
        f"({(tmp / 'four.ck').stat().st_size} bytes)")
    del ref, half, resumed
    dcfg = SimConfig(nrows=MULTI_DUMP_SHAPE, ncols=MULTI_DUMP_SHAPE, temp=1.5,
                     backend="bit1")
    one = Simulation(dcfg)
    four = Simulation(SimConfig(ndev=4, **vars_of(dcfg)), mesh=mesh_of(4))
    for s in (one, four):
        s.advance(2)
    one.dump(str(tmp / "one.txt"))
    four.dump(str(tmp / "lat.txt"))
    shards = sorted(tmp.glob("lat_shard*.txt"))
    require([p.name for p in shards] ==
            [f"lat_shard{k:04d}.txt" for k in range(4)],
            f"[multi] per-shard dumps {[p.name for p in shards]}")
    require(b"".join(p.read_bytes() for p in shards)
            == (tmp / "one.txt").read_bytes(),
            "[multi] the per-shard dumps, joined, differ from one device's")
    say(f"[multi] per-shard dumps: {MULTI_DUMP_SHAPE}^2 bit1 over 4 slabs "
        f"writes {', '.join(p.name for p in shards)}, joined byte-identical "
        f"to one device's dump")


def vars_of(cfg) -> dict:
    """cfg's fields, but ndev and device."""
    import dataclasses
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in ("ndev", "device")}


def multi_sw(mesh_of, where, launches):
    """The cluster case: --algo sw's README lattice (SW_SHAPE^2, T = Tc)
    over 4 slabs of the card against one device, MULTI_SW_ITERS updates:
    each slab labelled by the three kernels (tile_roots, hook_roots and
    flatten_roots once a slab an update; tile_roots alone where a slab is
    one tile), the slabs joined across their edges; the lattice and up
    counts equal."""
    cfg = SimConfig(nrows=SW_SHAPE, ncols=SW_SHAPE, temp=TCRIT)
    one = cluster.SwendsenWang(cfg)
    one.advance(MULTI_SW_ITERS)
    sim = cluster.SwendsenWang(SimConfig(ndev=4, **vars_of(cfg)),
                               mesh=mesh_of(4))
    for f in COUNTERS:
        f.launches = 0
    sim.advance(MULTI_SW_ITERS)
    torch.cuda.synchronize()
    got = slab_launches()
    L = SW_SHAPE // 4
    whole = cluster.whole_replica_tiles((L, SW_SHAPE),
                                        cluster.pick_tile(L, SW_SHAPE))
    want = {f.__name__: 4 * MULTI_SW_ITERS
            for f in cluster.LABEL_PHASES[:1 if whole else 3]}
    require(got == want, f"[multi] SW over 4 slabs launched {got}, "
            f"expected {want}")
    for k, v in got.items():
        launches[k] += v
    require(all(torch.equal(a, b) for a, b in zip(sim.bits(), one.bits()))
            and sim.measure() == one.measure(),
            "[multi] cluster: the 4-slab SW lattice differs from one "
            "device's")
    say(f"[multi] cluster: SW {SW_SHAPE}^2 at Tc over 4 slabs {where}, "
        f"{MULTI_SW_ITERS} updates: launches {got}, lattice bit-identical "
        f"to one device (|m| = {one.measure()['magnetization']:.6f})")


def multi_timing(card, mesh_of, where, shape=MAIN_SHAPE, counts=MULTI_SLABS,
                 overlap_counts=(2, 4, 8), force=True):
    """The step loop's cost over slabs: MULTI_TIMED_STEPS steps of the
    flagship (shape^2 bit1 threefry13) on one device, through the slab
    path with one slab (force_collectives), over each of `counts` slabs
    on mesh_of(n) and with halo_overlap over `overlap_counts`; CUDA events
    on the first slab's device around the steps (ms a step), the host's
    clock around their enqueue (host ms a step) and around the steps and
    a synchronize of every device (wall ms a step), MULTI_TIMED_REPEATS
    times, the median. Every variant's state equals the one-device run's.
    On one card this is the host's cost of the slab loop and its halo
    views, not a scaling result."""
    from ising_tpu_torch.driver import Simulation
    from ising_tpu_torch.parallel import make_sharded_stepper
    base = dict(nrows=shape, ncols=shape, temp=1.5, backend="bit1",
                rng="threefry13")
    variants = [("1 slab", 1, False, False)]
    if force:
        variants.append(("1 slab, force_collectives", 1, True, False))
    variants += [(f"{n} slabs", n, False, False) for n in counts]
    variants += [(f"{n} slabs, halo_overlap", n, False, True)
                 for n in overlap_counts]
    steps = MULTI_TIMED_STEPS * (1 + MULTI_TIMED_REPEATS)
    out, ref = {}, None
    for what, n, forced, overlap in variants:
        cfg = SimConfig(ndev=n, halo_overlap=overlap, **base)
        sim = Simulation(cfg, mesh=mesh_of(n) if n > 1 else None)
        if forced:
            sim._step_n = make_sharded_stepper(cfg, sim.backend,
                                               force_collectives=True,
                                               mesh=[sim.device])[1]
        sim.advance(MULTI_TIMED_STEPS)           # warm-up
        runs, hosts, walls = [], [], []
        for _ in range(MULTI_TIMED_REPEATS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            sim.block()
            start.record()
            t0 = time.perf_counter()
            sim.advance(MULTI_TIMED_STEPS)
            hosts.append((time.perf_counter() - t0) * 1e3 / MULTI_TIMED_STEPS)
            end.record()
            sim.block()
            walls.append((time.perf_counter() - t0) * 1e3 / MULTI_TIMED_STEPS)
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end) / MULTI_TIMED_STEPS)
        if ref is None:
            ref = sim
        else:
            require(sim.step == ref.step == steps and
                    torch.equal(gather_rows(sim.black) if n > 1
                                else sim.black, ref.black),
                    f"[multi] timing: {what}'s state differs from 1 slab's")
        per_step = (6 if overlap else 2) * n
        med = lambda xs: sorted(xs)[len(xs) // 2]
        ms, host, wall = med(runs), med(hosts), med(walls)
        out[what] = {"slabs": n, "launches_per_step": per_step,
                     "ms_per_step": ms, "runs": runs,
                     "wall_ms_per_step": wall, "wall_runs": walls,
                     "host_ms_per_step": host, "host_runs": hosts,
                     "host_us_per_launch": host * 1e3 / per_step}
        say(f"[multi] timing {shape}^2 bit1 threefry13 {where}, {what}: "
            f"{ms:.4f} ms a step (CUDA events, median of "
            f"{MULTI_TIMED_REPEATS} x {MULTI_TIMED_STEPS} steps, range "
            f"{min(runs):.4f}-{max(runs):.4f}), wall {wall:.4f} ms a step, "
            f"{per_step} launches a step, host enqueue {host:.4f} ms a step "
            f"({host * 1e3 / per_step:.1f} us a launch) on {card['smi']}")
        if sim is not ref:
            del sim
    one = out["1 slab"]["ms_per_step"]
    for what, t in out.items():
        t["rate_vs_one_slab"] = one / t["ms_per_step"]
    say(f"[multi] timing {shape}^2 {where}, rate against 1 slab: "
        + ", ".join(f"{w} {t['rate_vs_one_slab']:.3f}"
                    for w, t in out.items()))
    del ref
    torch.cuda.empty_cache()
    return out


def phase_multi(card):
    """Row slabs on the one card (meshes of it repeated 2, 4 and 8 times):
    MULTICHIP_r05.json's eight cases at full width, each bit-identical to
    one device (flagship bit1 in three modes at 2, 4 and 8 slabs,
    halo_overlap on packed, disorder on packed and on bit1's J-plane path,
    replicas of 128^2, chacha8b, the field, a checkpoint saved at 1 slab
    and resumed at 4, SW at 4096^2), dense and mxu over 4 slabs, the
    per-shard dumps, and the step loop's time by slab count. Returns
    {"launches": {kernels line entry: launches}, "timing": ...}."""
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh_of, where = (lambda n: [dev] * n), "on one card"
    launches = collections.Counter()
    for case in MULTI_CASES:
        multi_case(mesh_of, where, *case, launches)
    with tempfile.TemporaryDirectory() as tmp:
        multi_files(mesh_of, where, Path(tmp), launches)
    multi_sw(mesh_of, where, launches)
    timing = multi_timing(card, mesh_of, where)
    say(f"[multi] launches over slabs by entry: {dict(launches)}")
    return {"launches": dict(launches), "timing": timing}


def example_lines(name: str, argv):
    """(lines, launches by wrapper, seconds) of the example `name` run with
    `argv` (ising_tpu_torch.examples.<name>.main), every launch count set
    to 0 just before and read just after."""
    import importlib
    main_of = importlib.import_module(f"ising_tpu_torch.examples.{name}").main
    for f in COUNTERS:
        f.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        main_of(list(argv))
    torch.cuda.synchronize()
    return out.getvalue().splitlines(), slab_launches(), \
        time.perf_counter() - t0


@contextlib.contextmanager
def timed_methods(methods):
    """Time every call of the methods {label: (class, name)} while the
    block runs, each between two device synchronizes (the one before it
    not counted), with a StepTimer a label; yields ({label: StepTimer},
    {label: [the instances called]}), and puts the methods back after."""
    timers = {label: StepTimer() for label in methods}
    selves = {label: [] for label in methods}
    saved = []
    for label, (cls, name) in methods.items():
        orig = cls.__dict__[name]
        saved.append((cls, name, orig))

        def timed(self, *a, _orig=orig, _label=label, **kw):
            torch.cuda.synchronize()
            timers[_label].start()
            out = _orig(self, *a, **kw)
            torch.cuda.synchronize()
            timers[_label].lap()
            if not any(x is self for x in selves[_label]):
                selves[_label].append(self)
            return out
        setattr(cls, name, timed)
    try:
        yield timers, selves
    finally:
        for cls, name, orig in saved:
            setattr(cls, name, orig)


def giant_numbers(lines) -> list:
    """giant_lattice's storage line and the numbers of its measurement
    line (the timings left out)."""
    keep = [ln for ln in lines if "GiB of storage" in ln]
    keep += [re.sub(r"\s*\(measure.*\)$", "", ln) for ln in lines
             if ln.startswith("|m| = ")]
    require(len(keep) == 2, f"giant_lattice printed {lines}")
    return keep


def examples_tc(card, launches):
    """tc_sweep at full width on bit1 (16384 replicas of 64^2 and of
    128^2): bit1_sweep launched 2 x 600 steps x 7 temperatures x 2 sizes
    times on the replica path and nothing else; every U4 finite and at
    most 2/3 + 0.01; the crossing line and the collapse line (or its
    skipped line) printed. Simulation.advance (the sweeps) and
    replica_magnetizations (the measurements) timed from outside the
    example, each call between two synchronizes; the rest is the set-ups
    and the host's analysis."""
    from ising_tpu_torch.driver import Simulation
    with timed_methods({"sweeps": (Simulation, "advance"),
                        "measure": (Simulation,
                                    "replica_magnetizations")}) as (t, _):
        lines, got, seconds = example_lines("tc_sweep", EX_TC_FLAGS)
    sweep_s, measure_s = t["sweeps"].total, t["measure"].total
    measurements = len(t["measure"].laps)
    want = 2 * EX_TC_STEPS * EX_TC_TEMPS * len(EX_TC_SIZES)
    require(got == {"bit1_sweep": want},
            f"[examples] tc_sweep {' '.join(EX_TC_FLAGS)} launched {got}, "
            f"expected {want} of bit1_sweep alone")
    launches["bit1_sweep[replicas]"] += want
    u4 = [float(re.search(r"U4=\s*(\S+)", ln).group(1)) for ln in lines
          if ln.startswith("L=")]
    require(len(u4) == EX_TC_TEMPS * len(EX_TC_SIZES)
            and all(math.isfinite(u) and u <= 2 / 3 + 0.01 for u in u4),
            f"[examples] tc_sweep U4 values {u4}")
    require(any(ln.startswith("Binder crossing estimate") for ln in lines)
            and any(ln.startswith("scaling collapse") for ln in lines),
            f"[examples] tc_sweep's crossing or collapse line is missing: "
            f"{lines[-3:]}")
    for ln in lines:
        say(f"[examples] tc_sweep | {ln}")
    flips = sum((EX_TC_REPLICAS_ACROSS * L) ** 2 for L in EX_TC_SIZES) \
        * EX_TC_STEPS * EX_TC_TEMPS
    rate = flips / (sweep_s * 1e9)
    rest = seconds - sweep_s - measure_s
    say(f"[examples] tc_sweep {' '.join(EX_TC_FLAGS)} (8192^2 and 16384^2, "
        f"{EX_TC_TEMPS} temperatures, {EX_TC_STEPS} steps): {seconds:.3f} s "
        f"wall; sweeps {sweep_s:.3f} s ({rate:.2f} flips/ns, "
        f"{len(t['sweeps'].laps)} advance calls), {measurements} "
        f"measurements {measure_s:.3f} s "
        f"({measure_s / measurements * 1e3:.3f} ms each, "
        f"{measure_s / seconds:.1%} of the wall time), the rest (set-ups, "
        f"the host's analysis) {rest:.3f} s; bit1_sweep launched {want} on "
        f"{card['smi']}")
    return {"wall_s": seconds, "rest_s": rest, "sweep_s": sweep_s,
            "measure_s": measure_s, "measurements": measurements,
            "sweep_flips_ns": rate, "launches": want, "u4": u4}


def sw_launch_counts(sims) -> collections.Counter:
    """The labeler's launches by update, summed over SwendsenWang runs."""
    counts = collections.Counter()
    for sim in sims:
        counts.update(sim.launch_counts)
    return counts


def examples_sw(launches):
    """tc_sweep --algo sw at 1024 replicas (2048^2 and 4096^2): the
    labeler's launches are those its updates make (tile_roots once an
    update, hook_roots and flatten_roots once an update that takes three
    launches), no sweep kernel launched."""
    with timed_methods({"advance": (cluster.SwendsenWang,
                                    "advance")}) as (_, sims):
        lines, got, seconds = example_lines("tc_sweep", EX_SW_FLAGS)
    counts = sw_launch_counts(sims["advance"])
    three = counts.get(3, 0)
    want = {k: v for k, v in (("tile_roots", sum(counts.values())),
                              ("hook_roots", three),
                              ("flatten_roots", three)) if v}
    require(sum(counts.values()) == EX_SW_UPDATES and got == want
            and sum(got.values()) == sum(k * v for k, v in counts.items()),
            f"[examples] tc_sweep --algo sw launched {got}; its updates "
            f"counted {counts}")
    require(len([ln for ln in lines if ln.startswith("L=")]) == 6,
            f"[examples] tc_sweep --algo sw printed {lines}")
    for k, v in got.items():
        launches[k] += v
    say(f"[examples] tc_sweep {' '.join(EX_SW_FLAGS)}: {seconds:.3f} s, "
        f"labeler launches {got} over {EX_SW_UPDATES} updates "
        f"({dict(counts)} by launches an update)")
    return {"wall_s": seconds, "launches": got}


def examples_sw_tc(card, launches):
    """The physics check of the Tc sweep: its Swendsen-Wang form at
    EX_SW_TC_FLAGS, whose Binder crossing must be finite and within
    EX_SW_TC_TOL of Onsager's Tc, and whose collapse line is printed."""
    lines, got, seconds = example_lines("tc_sweep", EX_SW_TC_FLAGS)
    require(got and set(got) <= {f.__name__ for f in cluster.LABEL_PHASES},
            f"[examples] tc_sweep {' '.join(EX_SW_TC_FLAGS)} launched {got}")
    for k, v in got.items():
        launches[k] += v
    for ln in lines:
        say(f"[examples] tc_sweep sw | {ln}")
    cross = [ln for ln in lines if ln.startswith("Binder crossing estimate")]
    tc = float(re.search(r"Tc ~ (\S+)", cross[0]).group(1)) if cross \
        else math.nan
    require(math.isfinite(tc) and abs(tc - TCRIT) <= EX_SW_TC_TOL * TCRIT
            and any(ln.startswith("scaling collapse") for ln in lines),
            f"[examples] tc_sweep {' '.join(EX_SW_TC_FLAGS)}: crossing {tc}, "
            f"not within {EX_SW_TC_TOL:.0%} of Tc = {TCRIT}: {lines[-3:]}")
    say(f"[examples] tc_sweep {' '.join(EX_SW_TC_FLAGS)}: crossing {tc:.4f} "
        f"({abs(tc - TCRIT) / TCRIT:.2%} from Tc), launches {got}, "
        f"{seconds:.3f} s on {card['smi']}")
    return {"wall_s": seconds, "tc": tc, "launches": got}


def examples_card_vs_cpu(launches):
    """The seven examples on the card and through --device cpu: equal
    lines (giant_lattice: its storage and measurement numbers), each card
    run's launches counted (the CPU runs launch none)."""
    out = {}
    for name, argv, want in EX_SMALL:
        card, got, t_card = example_lines(name, argv)
        cpu, cpu_got, t_cpu = example_lines(name, argv + ["--device", "cpu"])
        require(not cpu_got, f"[examples] {name} on the CPU launched "
                f"{cpu_got}")
        if name == "giant_lattice":
            card, cpu = giant_numbers(card), giant_numbers(cpu)
        require(card == cpu and len(card) >= 2,
                f"[examples] {name} {' '.join(argv)}: the card's lines "
                f"differ from the CPU's:\n{card}\n{cpu}")
        if want is None:
            require(got and set(got) <= {f.__name__ for f in
                                         cluster.LABEL_PHASES}
                    and got.get("tile_roots"),
                    f"[examples] {name} launched {got}")
        else:
            require(got == want, f"[examples] {name} launched {got}, "
                    f"expected {want}")
        for k, v in got.items():
            launches[f"{k}[replicas]" if name == "tc_sweep" else k] += v
        out[name] = {"lines": len(card), "launches": got, "card_s": t_card,
                     "cpu_s": t_cpu}
        say(f"[examples] {name} {' '.join(argv)}: the card's {len(card)} "
            f"lines equal the CPU's; launches {got}; {t_card:.3f} s on the "
            f"card, {t_cpu:.3f} s on the CPU")
    return out


@contextlib.contextmanager
def captured_calls(cls, names):
    """Keep, for each method in names, the arguments and the result of its
    last call while the block runs: yields {name: (args, result)}."""
    seen = {}
    saved = [(name, cls.__dict__[name]) for name in names]
    for name, orig in saved:
        def kept(self, *a, _orig=orig, _name=name, **kw):
            out = _orig(self, *a, **kw)
            seen[_name] = (a, out)
            return out
        setattr(cls, name, kept)
    try:
        yield seen
    finally:
        for name, orig in saved:
            setattr(cls, name, orig)


def plain_giant_sums(b, w, row_chunk: int = 8192):
    """(up count, bond sum) of bit1 word planes as Python ints, from the
    plain decode path: int64 sums over decoded slabs of row_chunk rows
    (observables.count_spins, energy_rows_via), independent of the word
    observables that giant_lattice prints."""
    nrows = b.shape[0]
    up = 0
    for r in range(0, nrows, row_chunk):
        up += observables.count_spins(bit1.unpack_rows(b[r:r + row_chunk]),
                                      bit1.unpack_rows(w[r:r + row_chunk]))[0]

    def decode_rows(r, n):
        return tuple(bit1.unpack_rows(observables._rows_wrap(x, r, n))
                     for x in (b, w))
    bonds = int(observables.energy_rows_via(decode_rows, nrows,
                                            row_chunk=row_chunk).sum())
    return up, bonds


def examples_giant(card, launches):
    """giant_lattice at 65536^2 (4.29 G spins, past 2^32): bit1_sweep
    launched 2 x 33 times; its word-domain up count and bond sum (the
    offset-1 correlation sum too) equal the int64 sums of the plain decode
    path over row slabs, and its printed |m| and E/N are those sums'; the
    example's own init, step and measure times printed."""
    with captured_calls(bit1.Bit1Backend, ("row_up_counts", "energy_rows",
                                           "corr_rows")) as seen:
        lines, got, seconds = example_lines("giant_lattice", EX_GIANT_FLAGS)
    nspins = int(EX_GIANT_FLAGS[1]) * int(EX_GIANT_FLAGS[3])
    require(nspins >= 2 ** 32, f"[examples] giant_lattice at {nspins} spins")
    require(got == {"bit1_sweep": 2 * 33},
            f"[examples] giant_lattice 65536^2 launched {got}")
    launches["bit1_sweep"] += got["bit1_sweep"]
    for ln in lines:
        say(f"[examples] giant_lattice | {ln}")
    (b, w), words_up = seen["row_up_counts"]
    n_up, bonds = int(words_up.sum()), int(seen["energy_rows"][1].sum())
    corr1 = int(seen["corr_rows"][1][0].sum())
    t0 = time.perf_counter()
    plain_up, plain_bonds = plain_giant_sums(b, w)
    t_plain = time.perf_counter() - t0
    line = giant_numbers(lines)[1]
    m = f"{abs(2 * plain_up - nspins) / nspins:.6f}"
    e = f"{-float(plain_bonds) / nspins:.6f}"
    require(n_up == plain_up and bonds == plain_bonds == corr1
            and line.startswith(f"|m| = {m}  E/N = {e}  "),
            f"[examples] giant_lattice 65536^2: words up {n_up}, bonds "
            f"{bonds}, offset-1 correlation {corr1}; decoded up {plain_up}, "
            f"bonds {plain_bonds} (|m| {m}, E/N {e}); printed {line}")
    times = {k: float(re.search(pat, "\n".join(lines)).group(1))
             for k, pat in (("init_s", r"init \+ compile: (\S+)s"),
                            ("step_s", r"steps: (\S+)s wall"),
                            ("measure_s", r"corr128: (\S+)s\)"))}
    say(f"[examples] giant_lattice {' '.join(EX_GIANT_FLAGS)}: up count "
        f"{n_up} and bond sum {bonds} of {nspins} spins equal to the "
        f"decoded slabs' int64 sums ({t_plain:.3f} s); init + first step "
        f"{times['init_s']} s, 32 steps {times['step_s']} s, measure + "
        f"energy + corr128 {times['measure_s']} s (the example's own "
        f"lines), wall {seconds:.3f} s on {card['smi']}")
    del b, w, seen
    torch.cuda.empty_cache()
    return dict(times, n_up=n_up, bonds=bonds, plain_s=t_plain,
                wall_s=seconds)


def examples_profile(card, launches):
    """The CLI at 16384^2 on bit1 with -n 16, without and with --profile
    DIR: the trace file in DIR holds device events of the bit1 kernels,
    the magnetization lines are equal, both wall times printed."""
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp) / "trace"
        for what, extra in (("plain", []), ("profile", ["--profile",
                                                        str(d)])):
            for f in COUNTERS:
                f.launches = 0
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                code = cli.main(EX_PROFILE_FLAGS + extra)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = slab_launches()
            require(code == 0 and got == {"bit1_sweep": 2 * 16},
                    f"[examples] the CLI {what} exited {code}, launched "
                    f"{got}")
            launches["bit1_sweep"] += got["bit1_sweep"]
            runs[what] = (out.getvalue().splitlines(), seconds)
        lines = {w: [ln for ln in r[0] if "magnetization" in ln]
                 for w, r in runs.items()}
        require(lines["plain"] == lines["profile"] and len(lines["plain"]) == 6
                and f"Wrote profiler trace to {d}" in runs["profile"][0],
                f"[examples] --profile changed the lines: {lines}")
        files = sorted(p.name for p in d.iterdir())
        events = json.loads((d / "trace.json").read_text())["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"
                   and device_trace.is_kernel(e.get("name", ""))
                   and "bit1" in e["name"]]
        require(len(kernels) >= 2 * 16,
                f"[examples] the --profile trace {files} holds "
                f"{len(kernels)} bit1 kernel events")
        size = (d / "trace.json").stat().st_size
    t_plain, t_prof = runs["plain"][1], runs["profile"][1]
    say(f"[examples] --profile: {' '.join(EX_PROFILE_FLAGS)} wrote {files} "
        f"({size} bytes, {len(kernels)} bit1 kernel events); magnetization "
        f"lines equal to the run without it; wall {t_plain:.3f} s without, "
        f"{t_prof:.3f} s with ({t_prof / t_plain:.2f}x) on {card['smi']}")
    return {"plain_s": t_plain, "profile_s": t_prof,
            "kernel_events": len(kernels)}


def numpy_write_hex(path, full):
    """io's numpy hex writer, where the codec does not build."""
    from ising_tpu_torch import io as lio
    with open(path, "wb") as f:
        lio._write_rows(f, full, "hex")


def numpy_read_hex(path):
    """io's numpy hex reader, where the codec does not build."""
    from ising_tpu_torch import io as lio
    with open(path, "rb") as f:
        return lio._read_hex_rows(f)


def examples_codec(card):
    """The native codec built (io.native_codec() is not None), and a
    16384^2 bit1 hex dump through io.dump_lattice has the crc32 of the
    codec's and of numpy's writes; each read returns the lattice. The dump
    timed whole (decode, host copy, write); the write and the read alone,
    through the codec and through numpy, in turns (codec, numpy, numpy,
    codec) on the same host array."""
    import zlib

    from ising_tpu_torch import io as lio
    from ising_tpu_torch.driver import Simulation
    from ising_tpu_torch.native import codec as native
    require(lio.native_codec() is not None,
            "[examples] the native codec did not build (g++)")
    build_s = native.load()[1]
    sim = Simulation(SimConfig(nrows=MAIN_SHAPE, ncols=MAIN_SHAPE, temp=1.5,
                               backend="bit1"))
    sim.advance(2)
    b, w = sim.bits()

    def crc(path):
        c = 0
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 24), b""):
                c = zlib.crc32(chunk, c)
        return c

    writers = {"codec": lambda p, full: native.write_hex(str(p), full),
               "numpy": numpy_write_hex}
    readers = {"codec": lambda p: native.read_hex(str(p)),
               "numpy": numpy_read_hex}
    times = {(op, k): [] for op in ("write", "read") for k in writers}
    crcs = {}
    with tempfile.TemporaryDirectory() as tmp:
        dump = Path(tmp) / "dump.txt"
        t0 = time.perf_counter()
        lio.dump_lattice(str(dump), b, w)
        t_dump = time.perf_counter() - t0
        size, crcs["dump_lattice"] = dump.stat().st_size, crc(dump)
        dump.unlink()
        t0 = time.perf_counter()
        full = lio.full_bits_host(b, w)
        t_host = time.perf_counter() - t0
        for what in ("codec", "numpy", "numpy", "codec"):
            path = Path(tmp) / f"{what}.txt"
            t0 = time.perf_counter()
            writers[what](path, full)
            times["write", what].append(time.perf_counter() - t0)
            crcs[what] = crc(path)
            t0 = time.perf_counter()
            back = readers[what](path)
            times["read", what].append(time.perf_counter() - t0)
            require(np.array_equal(back, full),
                    f"[examples] the {what} read of a hex dump differs")
            del back
            path.unlink()
    require(len(set(crcs.values())) == 1
            and size == MAIN_SHAPE * (MAIN_SHAPE + 1),
            f"[examples] hex dumps' crc32 differ: {crcs} ({size} bytes)")

    def fmt(op, k):
        return ", ".join(f"{t:.3f}" for t in times[op, k])
    say(f"[examples] native codec (g++ {build_s:.2f} s, 0.00: cached): a "
        f"{MAIN_SHAPE}^2 bit1 hex dump, {size} bytes, crc32 "
        f"{crcs['codec']:08X} through io.dump_lattice, the codec and numpy; "
        f"io.dump_lattice {t_dump:.3f} s (decode and host copy "
        f"{t_host:.3f} s); alone and in turns, the write: codec "
        f"{fmt('write', 'codec')} s, numpy {fmt('write', 'numpy')} s; the "
        f"read: codec {fmt('read', 'codec')} s, numpy {fmt('read', 'numpy')}"
        f" s on {card['smi']}")
    del sim, b, w, full
    torch.cuda.empty_cache()
    return {"dump_s": t_dump, "host_s": t_host, "build_s": build_s,
            "crc32": crcs["codec"],
            **{f"{op}_{k}_s": v for (op, k), v in times.items()}}


def phase_examples(card):
    """The example studies on the card (EX_* above): the full-width Tc
    sweep, its SW form and the SW physics check, the seven examples against the CPU, giant_lattice
    at 65536^2, --profile and the codec. Returns {"launches": {kernels
    line entry: launches}, ...}."""
    t0 = time.perf_counter()
    launches = collections.Counter()
    out = {"tc_sweep": examples_tc(card, launches),
           "tc_sweep_sw": examples_sw(launches),
           "tc_sweep_sw_tc": examples_sw_tc(card, launches),
           "card_vs_cpu": examples_card_vs_cpu(launches),
           "giant_65536": examples_giant(card, launches),
           "profile": examples_profile(card, launches),
           "codec": examples_codec(card)}
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    out["launches"] = dict(launches)
    say(f"[examples] launches by entry: {dict(launches)}; the phase "
        f"{out['phase_s']:.1f} s")
    return out


def cli_lines(argv) -> list:
    """cli.main(argv)'s lines but the timing and device lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli.main(argv)
    require(code == 0, f"the CLI exited {code} on {argv}")
    return [ln for ln in out.getvalue().splitlines()
            if not ln.startswith(("Kernel execution", "\tdevice:"))]


def main_gpus() -> int:
    """--gpus: row slabs over the machine's own GPUs (make_mesh: cuda:0 ..
    cuda:N-1, N = torch.cuda.device_count() >= 2), each slab on a device
    of its own, halo rows copied between devices: GPUS_CASES over 2, 4
    and 8 GPUs (those of them the machine holds), each bit-identical to one
    device with its launches counted; the checkpoint, dump and SW cases
    over 4 GPUs where there are 4; the CLI's --devs N lines equal to
    --devs 1's; and the step loop timed at MAIN_SHAPE^2 and
    GPUS_TIMED_SHAPE^2 over 1 and those GPU counts. Prints no result
    line."""
    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(BUDGET_S)
    faulthandler.dump_traceback_later(BUDGET_S + 30, exit=True)
    try:
        card = phase_device()
        from ising_tpu_torch.parallel import make_mesh
        n = torch.cuda.device_count()
        require(n >= 2, f"--gpus needs 2 or more GPUs, found {n}")
        phase_build()
        counts = tuple(c for c in (2, 4, 8) if c <= n)
        mesh_of, where = make_mesh, f"on {n} GPUs"
        say(f"[gpus] mesh {make_mesh(n)}")
        launches = collections.Counter()
        for name, backend, rng, extra, _ in GPUS_CASES:
            multi_case(mesh_of, where, name, backend, rng, extra, counts,
                       launches)
        if n >= 4:
            with tempfile.TemporaryDirectory() as tmp:
                multi_files(mesh_of, where, Path(tmp), launches)
            multi_sw(mesh_of, where, launches)
        flags = ["--backend", "bit1", "-x", str(MAIN_SHAPE), "-y",
                 str(MAIN_SHAPE), "-w", "8", "-n", "64", "-p", "16", "-t",
                 "1.5", "-J", "0.1"]
        one = cli_lines(flags)
        many = cli_lines(flags + ["--devs", str(n)])
        require([ln for ln in many if "devices" not in ln]
                == [ln for ln in one if "devices" not in ln]
                and f"\tdevices: {n}" in many,
                f"the CLI's --devs {n} lines differ from --devs 1's")
        say(f"[gpus] the CLI at {MAIN_SHAPE}^2 bit1 -J 0.1 with --devs {n}: "
            f"its {len(many)} lines equal --devs 1's")
        for shape in (MAIN_SHAPE, GPUS_TIMED_SHAPE):
            multi_timing(card, mesh_of, where, shape, counts, (n,),
                         force=False)
        say(f"[gpus] launches over GPUs by entry: {dict(launches)}")
        say(f"[time] {elapsed():.1f} s")
    except Failed as e:
        say(f"FAILED: {e}")
        return 1
    finally:
        signal.alarm(0)
        faulthandler.cancel_dump_traceback_later()
    return 0


def event_ms(fn, n: int = 1) -> float:
    """ms per call of fn() over n calls (time_launches), after one warm-up
    call."""
    fn()
    return time_launches(lambda _: fn(), n)


def launch_ms(setup, fn, n: int) -> float:
    """ms per call of fn() over n calls, each after setup() and timed alone
    (CUDA events around fn only), after one warm-up call."""
    setup()
    fn()
    pairs = []
    for _ in range(n):
        setup()
        pairs.append((torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)))
        pairs[-1][0].record()
        fn()
        pairs[-1][1].record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / n


def host_ms(fn) -> float:
    """ms of one call of fn() on the host clock, the card synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def crossing_bonds(Y, X, tile, device):
    """Bonds of the full lattice whose ends lie in two tiles (the ones
    hook_roots reads): right bonds of the columns and down bonds of the
    rows whose next site is in another tile."""
    def crossing(n, t):
        i = torch.arange(n, device=device)
        return int((i // t != (i + 1) % n // t).sum())
    return crossing(X, tile[1]) * Y + crossing(Y, tile[0]) * X


def phase_sw_timing(card, states):
    """At 4096^2 and 16384^2, from the lattice the main path left at Tc:
    the bonds of one update at Tc, then the labeling (ms, launches)
    against its 6 B a site bound and the plain label_clusters (bit for
    bit, and timed), each kernel alone (tile_roots, hook_roots on a fresh
    copy of tile_roots' plane, flatten_roots on a fresh copy of the hooked
    one) against its bytes bound and its plain version, the depth of the
    hooked forest, and the other parts of an update: bonds, coins and
    flip, the ghost. At 4096^2 also the labeling at other tiles. Returns
    {shape: timing}."""
    out = {}
    seed, step = 12345, 1000
    thr = cluster.bond_threshold(TCRIT)
    thr_ghost = cluster.bond_threshold(TCRIT, 0.1)
    hbm_ms = lambda nbytes: nbytes / HBM_BYTES_PER_S * 1e3
    for shape, full in states.items():
        Y = X = shape
        o_r, o_d, _ = cluster.draw_bonds(full, thr, seed, step)
        labels, stats = cluster.label_clusters_tiled(o_r, o_d,
                                                     return_stats=True)
        want = cluster.label_clusters(o_r, o_d)
        plain_ms = host_ms(lambda: cluster.label_clusters(o_r, o_d))
        require(torch.equal(labels, want) and stats["launches"] == 3,
                f"label_clusters_tiled != label_clusters at {shape}^2, Tc "
                f"({stats})")
        runs = sorted(event_ms(lambda: cluster.label_clusters_tiled(o_r, o_d),
                               5) for _ in range(TIMED_REPEATS))
        ms = runs[len(runs) // 2]
        tile = cluster.pick_tile(Y, X)
        kw = dict(tile=tile)
        # each kernel alone
        roots = torch.empty((Y, X), dtype=torch.int32, device=full.device)
        cluster.tile_roots(o_r, o_d, roots, **kw)
        roots_ms = event_ms(lambda: cluster.tile_roots(o_r, o_d, roots, **kw),
                            20)
        work = torch.empty_like(roots)
        hook_ms = launch_ms(lambda: work.copy_(roots),
                            lambda: cluster.hook_roots(o_r, o_d, work, **kw),
                            20)
        hooked = work.clone()
        flatten_ms = launch_ms(lambda: work.copy_(hooked),
                               lambda: cluster.flatten_roots(work, work, **kw),
                               20)
        require(torch.equal(work, want), f"hook + flatten alone != plain at "
                f"{shape}^2")
        # the hooked forest: depth (pointer jumps to the roots) and hooks
        f, jumps = hooked.reshape(-1).to(torch.int64), 0
        while not torch.equal(f[f], f):
            f, jumps = f[f], jumps + 1
        flat_roots = roots.reshape(-1).to(torch.int64)
        u, v = cluster._bond_edges(o_r, o_d, Y, X)
        tiles = cluster._tile_of(Y, X, tile, full.device)
        cross = tiles[u] != tiles[v]
        ends = torch.unique(flat_roots[torch.cat([u[cross], v[cross]])])
        hooks = int(ends.numel() - torch.unique(f[ends]).numel())
        open_cross = int(cross.sum())
        del u, v, tiles, cross, f
        plain_roots_ms = host_ms(lambda: cluster.tile_roots_reference(
            o_r, o_d, **kw))
        ref_hooked = cluster.hook_reference(roots, o_r, o_d, **kw)
        plain_hook_ms = host_ms(lambda: cluster.hook_reference(
            roots, o_r, o_d, **kw))
        plain_flatten_ms = host_ms(lambda: cluster.flatten_reference(
            ref_hooked))
        del ref_hooked
        # bounds: the labeling and tile_roots 6 B a site (bonds in, one
        # int32 plane out); hook_roots the crossing bonds it reads (1 B
        # each), two parent reads an open crossing bond and one write a
        # hook; flatten_roots 8 B a site (parent in, labels out)
        bound_ms = hbm_ms(LABEL_BYTES_PER_SITE * Y * X)
        hook_bytes = (crossing_bonds(Y, X, tile, full.device)
                      + 8 * open_cross + 4 * hooks)
        kernels = {
            "tile_roots": {"ms": roots_ms, "plain_ms": plain_roots_ms,
                           "bound_ms": bound_ms},
            "hook_roots": {"ms": hook_ms, "plain_ms": plain_hook_ms,
                           "bound_ms": hbm_ms(hook_bytes),
                           "open_crossing_bonds": open_cross,
                           "hooks": hooks},
            "flatten_roots": {"ms": flatten_ms, "plain_ms": plain_flatten_ms,
                              "bound_ms": hbm_ms(8 * Y * X)}}
        bonds_ms = event_ms(lambda: cluster.draw_bonds(full, thr, seed, step))
        field_bonds_ms = event_ms(lambda: cluster.draw_bonds(
            full, thr, seed, step, field=0.1, thr_ghost=thr_ghost))
        _, _, ghost = cluster.draw_bonds(full, thr, seed, step, field=0.1,
                                         thr_ghost=thr_ghost)
        flip_ms = event_ms(lambda: cluster.flip_clusters(full, labels, seed,
                                                         step))
        ghost_flip_ms = event_ms(lambda: cluster.flip_clusters(
            full, labels, seed, step, ghost))
        density = float((o_r.sum() + o_d.sum()) / (2 * Y * X))
        t = {"ms": ms, "runs": runs, "launches": stats["launches"],
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "kernels": kernels, "forest_jumps": jumps,
             "bond_density": density, "bonds_ms": bonds_ms,
             "bonds_field_ms": field_bonds_ms, "flip_ms": flip_ms,
             "flip_field_ms": ghost_flip_ms, "tile": tile}
        say(f"[sw-timing] {shape}^2 at Tc (bond density {density:.4f}): "
            f"labeling {ms:.4f} ms (median of {TIMED_REPEATS}, range "
            f"{runs[0]:.4f}-{runs[-1]:.4f}), {stats['launches']} launches "
            f"of tile {tile}, no host read; bound {bound_ms:.4f} ms (bytes, "
            f"{LABEL_BYTES_PER_SITE} B a site), {bound_ms / ms:.2%} of it; "
            f"plain label_clusters {plain_ms:.2f} ms on {card['smi']}")
        for name, k in kernels.items():
            say(f"[sw-timing] {shape}^2 {name}: {k['ms']:.4f} ms, bound "
                f"{k['bound_ms']:.4f} ms (bytes, {k['bound_ms'] / k['ms']:.2%}"
                f" of it), plain {k['plain_ms']:.2f} ms")
        say(f"[sw-timing] {shape}^2 hooks: {open_cross} open bonds across "
            f"tiles, {hooks} hooks, the hooked forest {jumps} pointer jumps "
            f"deep; per update: bonds {bonds_ms:.3f} ms ({field_bonds_ms:.3f}"
            f" with the ghost), labeling {ms:.3f}, coins and flip "
            f"{flip_ms:.3f} ({ghost_flip_ms:.3f} with the ghost)")
        if shape == SW_SHAPE:
            t["per_tile"] = {}
            for tl in LABEL_TILES:
                got = cluster.label_clusters_tiled(o_r, o_d, tile=tl)
                require(torch.equal(got, want), f"tile {tl} != plain")
                t["per_tile"][f"{tl[0]}x{tl[1]}"] = event_ms(
                    lambda: cluster.label_clusters_tiled(o_r, o_d, tile=tl),
                    5)
            say(f"[sw-timing] {shape}^2 labeling ms by tile "
                + ", ".join(f"{tl}: {v:.4f}"
                            for tl, v in t["per_tile"].items()))
        out[shape] = t
        del o_r, o_d, labels, want, ghost, roots, work, hooked
        torch.cuda.empty_cache()
    return out


def label_entries(sw_main, timing, cases, max_abs_err, info):
    """The kernels line's entries of the labeler's three kernels: launches
    of the --algo sw main-path runs, each kernel's time at 4096^2 at Tc
    beside its bound and plain version, and the whole labeling's."""
    t = timing[SW_SHAPE]
    labeling = {k: t[k] for k in ("ms", "runs", "launches", "plain_ms",
                                  "bound_ms", "tile", "forest_jumps")}
    entries = []
    for f in cluster.LABEL_PHASES:
        name = f.__name__
        k = t["kernels"][name]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": LABEL_KERNEL["source"],
            "replaces": LABEL_KERNEL["replaces"],
            "path": "--algo sw",
            "launches": sum(r["launches"][name] for r in sw_main.values()),
            "max_abs_err": max_abs_err,
            "compared_cases": cases,
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "held_against_plain": True,
            "build_s": info.seconds,
            "labeling": labeling,
            "per_shape": {f"{s}^2": tt["kernels"][name]
                          for s, tt in timing.items()},
        })
    entries[0]["main_path"] = {
        what: {k: v for k, v in r.items() if k != "full"}
        for what, r in sw_main.items()}
    return entries


TURNS_FLAGS = ["-x", str(MAIN_SHAPE), "-y", str(MAIN_SHAPE), "-w", "8", "-n",
               "64", "-p", "16"]
# (backend, ISING_TPU_FUSED, rng mode) of the CLI runs timed in turns: bit1
# in the main path's threefry13 and chacha6b and in bench.py's hw, then
# dense, packed and its fused step in threefry13
TURNS_RUNS = (("bit1", None, "threefry13"), ("bit1", None, "chacha6b"),
              ("bit1", None, "hw"), ("dense", None, "threefry13"),
              ("packed", None, "threefry13"), ("packed", "1", "threefry13"))


def phase_turns(old_tree: str):
    """The CLI from old_tree and from this tree in turns, one process a
    run, for each of TURNS_RUNS; the second runs compare (a first run pays
    its tree's build)."""
    for backend, fused, mode in TURNS_RUNS:
        what = backend + (f" ISING_TPU_FUSED={fused}" if fused else "")
        with fused_env(fused):
            runs = [[tree, cli_turns.run_cli(
                tree, ["--backend", backend, "--rng", mode] + TURNS_FLAGS)]
                for tree in (old_tree, ".", ".", old_tree)]
        say(f"[turns] {what} {mode} {MAIN_SHAPE}^2, flips/ns: "
            + ", ".join(f"{t} {r:.2f}" for t, r in runs)
            + f"; second runs {runs[2][1] / runs[3][1]:.3f}x the old tree's")
        say(json.dumps({"what": f"{what} {mode}", "runs": runs}))


def old_library(old_tree: str):
    """(kernel library, bit1's accept_table for it) of another checkout,
    built there by its own kernel_lib, with this tree's signatures of the
    bit1 and packed entry points (unchanged since they were ported)."""
    out = subprocess.run(
        [sys.executable, "-c", "from ising_tpu_torch.ops import kernel_lib; "
         "info = kernel_lib.load()[1]; "
         "print(info.path, kernel_lib.TABLE_WORDS, info.seconds)"],
        cwd=old_tree, capture_output=True, text=True, check=True,
        timeout=kernel_lib.NVCC_TIMEOUT_S).stdout
    path, words, seconds = out.split()[-3:]
    say(f"[against] {old_tree}'s kernel library: nvcc {float(seconds):.1f} s "
        f"(0.0: cached)")
    lib = ctypes.CDLL(path)
    for name in ("bit1_sweep_launch", "bit1_planes_launch",
                 "packed_sweep_launch", "packed_fused_step_launch",
                 "packed_fused_step_manual_launch", "ising_cuda_error_string"):
        getattr(lib, name).argtypes, getattr(lib, name).restype = (
            kernel_lib.SIGNATURES[name])
    return lib, table_of_layout(int(words))


def table_of_layout(words: int):
    """bit1.accept_table for a kernel library whose AcceptTable
    (bit1_planes.cu) has `words` words: this tree's, or the 3 + 10 + 10 x
    TABLE_KBITS words (t4k, t8k, the draw-class bits, the always-words, the
    class bit-words) of trees whose kernel read t4k and t8k by value."""
    if words == kernel_lib.TABLE_WORDS:
        return bit1.accept_table
    K, ours = kernel_lib.TABLE_KBITS, bit1.accept_table
    require(words == 3 + 10 + 10 * K, f"an AcceptTable of {words} words")

    @functools.lru_cache(maxsize=16)   # built once, as bit1.accept_table is
    def table(kbits, t4k, t8k, tvals10, always10):
        new = list(ours(kbits, t4k, t8k, tvals10, always10))
        return (ctypes.c_uint32 * words)(t4k, t8k, *new[2 * K:])
    return table


@contextlib.contextmanager
def library(lib, table=None):
    """The wrappers launch `lib`'s kernels for the block (bit1's planes
    kernel with the threshold table that `table` lays out)."""
    saved = kernel_lib.load, bit1.accept_table
    kernel_lib.load = lambda: (lib, None)
    bit1.accept_table = table or saved[1]
    try:
        yield
    finally:
        kernel_lib.load, bit1.accept_table = saved


def phase_against_kernels(card, old_tree: str, bit1_cases=None):
    """bit1_sweep (timing_cases: every mode, the field, every disorder and
    replica path), packed_sweep (packed_timing_cases) and both fused
    kernels (the main modes) from old_tree's library and from this tree's,
    at 16384^2 on the same random words: their results equal, then each
    timed (median of TIMED_REPEATS x TIMED_LAUNCHES) in turns, old, new,
    new, old. bit1_cases: only these (mode, field, path, greedy) cases of
    bit1_sweep, and no other kernel."""
    (old, old_table), new = old_library(old_tree), kernel_lib.load()[0]
    libs = {"old": (old, old_table), "new": (new, None)}
    dev = torch.device("cuda")
    gen = np.random.default_rng(11)
    H, W = MAIN_SHAPE, MAIN_SHAPE // 16
    planes = [random_words(gen, (H, W), dev) for _ in range(2)]
    jword = random_words(gen, (H, W), dev)
    W1 = MAIN_SHAPE // 64
    words1 = [random_words(gen, (H, W1), dev) for _ in range(2)]
    links = [random_words(gen, (H, W1), dev) for _ in range(4)]
    out = {}

    def turns(what, launch, result):
        got = []
        for lib in ("old", "new"):
            with library(*libs[lib]):
                got.append(result())
        require(all(torch.equal(a, b) for a, b in zip(*got)),
                f"{what}: the old and new kernels differ")
        runs = []
        for lib in ("old", "new", "new", "old"):
            with library(*libs[lib]):
                runs.append(median_ms(launch)[0])
        ratio = (runs[1] + runs[2]) / (runs[0] + runs[3])
        out[what] = {"old_ms": [runs[0], runs[3]], "new_ms": runs[1:3],
                     "new_over_old": ratio}
        say(f"[against] {MAIN_SHAPE}^2 {what}: old {runs[0]:.4f} ms, new "
            f"{runs[1]:.4f}, new {runs[2]:.4f}, old {runs[3]:.4f}; new / old "
            f"{ratio:.3f}, equal results, on {card['smi']}")

    for mode, field, path, greedy in bit1_cases or [
            (*case, False) for case in timing_cases()]:
        temp = 0.0 if greedy else 1.5
        thr = ising.threshold_table(temp, field)
        jplanes, geo = (None, {}) if path is None else geometry_kwargs(
            path, *((TIMED_CSL, TIMED_YSL) if "replicas" in path
                    else (None, None)), links)
        kw = dict(seed=golden.SEED, rng_mode=mode, greedy=greedy, **geo,
                  **bit1.plane_accept_args(mode, temp, field))

        def launch(i, thr=thr, kw=kw, jplanes=jplanes):
            dst, src = words1[i % 2], words1[1 - i % 2]
            bit1.bit1_sweep(dst, src, src[-1:], src[:1], thr, 0, i, jplanes,
                            color=i % 2, **kw)

        def result(thr=thr, kw=kw, jplanes=jplanes):
            d = [words1[0].clone(), words1[1].clone()]
            for color in (0, 1):
                dst, src = d[color], d[1 - color]
                bit1.bit1_sweep(dst, src, src[-1:], src[:1], thr, 0, 5,
                                jplanes, color=color, **kw)
            return tuple(d)

        turns("bit1_sweep " + mode + (" T=0" if greedy else "")
              + (f" h={field}" if field else "")
              + (f" {path}" if path else ""), launch, result)
    if bit1_cases:
        return out
    for mode, field, path in packed_timing_cases():
        thr = ising.threshold_table(1.5, field)
        kw = packed_kwargs(mode, 1.5, field, path, TIMED_CSL, TIMED_YSL)
        jw = jword if path and "jword" in path else None

        def launch(i, thr=thr, kw=kw, jw=jw):
            dst, src = planes[i % 2], planes[1 - i % 2]
            packed.packed_sweep(dst, src, src[-1:], src[:1], thr, 0, i, jw,
                                color=i % 2, **kw)

        def result(thr=thr, kw=kw, jw=jw):
            d = planes[0].clone()
            src = planes[1]
            packed.packed_sweep(d, src, src[-1:], src[:1], thr, 0, 5, jw,
                                color=0, **kw)
            return (d,)

        turns("packed_sweep " + mode + (f" h={field}" if field else "")
              + (f" {path}" if path else ""), launch, result)
    for mode in PACKED_MAIN_MODES:
        thr = ising.threshold_table(1.5)
        kw = dict(seed=golden.SEED, rng_mode=mode)
        for fn in FUSED.values():
            turns(f"{fn.__name__} {mode}",
                  lambda i, fn=fn, thr=thr, kw=kw: fn(*planes, thr, 0, i, **kw),
                  lambda fn=fn, thr=thr, kw=kw: fn(*planes, thr, 0, 1, **kw))
    return out


def turns_case(spec: str):
    """(mode, field, path, greedy) of a --turns case MODE[,PATH][,h=F][,T=0]:
    an rng mode, a disorder or replica path of GEOMETRY_PATHS, a field
    and the greedy quench."""
    mode, *rest = spec.split(",")
    require(mode in PORTED_MODES, f"--turns: no rng mode {mode!r}")
    field, path, greedy = 0.0, None, False
    for part in rest:
        if part == "T=0":
            greedy = True
        elif part.startswith("h="):
            field = float(part[2:])
        else:
            require(part in GEOMETRY_PATHS, f"--turns: no path {part!r}")
            path = part
    return mode, field, path, greedy


def main_turns(other: str, specs) -> int:
    """python3 chip_smoke.py --turns OTHER_TREE CASE ...: bit1_sweep in each
    CASE (turns_case) from OTHER_TREE's kernel library and from this
    tree's, at 16384^2 in turns (phase_against_kernels), with both
    libraries' build times. A probe of a kernel edit, not the check: it
    prints no result line and exits 0 when every case ran, equal."""
    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(AGAINST_S)
    try:
        card = phase_device()
        cases = [turns_case(spec) for spec in specs]
        require(cases, "--turns: no case given")
        info = kernel_lib.load()[1]
        frames = stack_frames(info.ptxas)
        say(f"[against] this tree's kernel library: nvcc {info.seconds:.1f} s "
            f"(0.0: cached), {len(frames)} kernels, stack frames in "
            f"{sorted(str(sass.kernel_key(k) or k) for k, v in frames.items() if v)}")
        phase_against_kernels(card, other, cases)
    except Failed as e:
        say(f"FAILED: {e}")
        return 1
    finally:
        signal.alarm(0)
    return 0


def _on_alarm(signum, frame):
    raise Failed("time budget exceeded")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--turns"] and len(argv) > 1:
        return main_turns(argv[1], argv[2:])
    if argv[:1] == ["--gpus"]:
        return main_gpus()
    against = argv[argv.index("--against") + 1] if "--against" in argv else None
    budget = BUDGET_S + (AGAINST_S if against else 0)
    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(budget)
    # Hard stop even if the main thread is stuck inside a CUDA call.
    faulthandler.dump_traceback_later(budget + 30, exit=True)
    try:
        card = phase_device()
        dev = torch.device("cuda")
        info, mix, loops = phase_build()
        say(f"[time] {elapsed():.1f} s")
        cases, max_err = phase_compare(dev)
        geo_cases, geo_err = phase_compare_geometry(dev)
        cases, max_err = cases + geo_cases, max(max_err, geo_err)
        say(f"[kernel] {cases} kernel-vs-plain cases equal, max abs err "
            f"{max_err}  [time {elapsed():.1f} s]")
        p_cases, p_err = phase_compare_packed(dev)
        say(f"[kernel] {p_cases} packed kernel-vs-plain cases equal, max abs "
            f"err {p_err}  [time {elapsed():.1f} s]")
        f_cases, f_err = phase_compare_fused(dev)
        say(f"[kernel] {f_cases} fused kernel-vs-plain cases equal, max abs "
            f"err {f_err}  [time {elapsed():.1f} s]")
        d_cases, d_err = phase_compare_planes(dev, "dense")
        m_cases, m_err = phase_compare_planes(dev, "mxu")
        say(f"[kernel] {d_cases} dense and {m_cases} mxu kernel-vs-plain "
            f"cases equal, max abs err {max(d_err, m_err)}  "
            f"[time {elapsed():.1f} s]")
        l_cases, l_err = phase_compare_labels(dev)
        say(f"[kernel] {l_cases} labeler kernel and labeling cases equal to "
            f"the plain versions, max abs err {l_err}  "
            f"[time {elapsed():.1f} s]")
        phase_golden()
        phase_fused_golden()
        phase_sw_golden()
        say(f"[time] {elapsed():.1f} s")
        ordered, paths = phase_main_path(card)
        p_ordered, p_paths = phase_main_path(card, "packed")
        f_main = phase_fused_main_path(card)
        say(f"[time] {elapsed():.1f} s")
        d_ordered, d_paths = phase_plane_main_path(card, "dense")
        m_ordered, _ = phase_plane_main_path(card, "mxu")
        say(f"[time] {elapsed():.1f} s")
        phase_xla_path(card)
        phase_packed_equality(card)
        phase_fused_equality(card)
        phase_plane_equality(card)
        say(f"[time] {elapsed():.1f} s")
        sw_main = phase_sw_main(card)
        say(f"[time] {elapsed():.1f} s")
        phase_io(card)
        say(f"[time] {elapsed():.1f} s")
        phase_pt(card)
        say(f"[time] {elapsed():.1f} s")
        multi = phase_multi(card)
        say(f"[time] {elapsed():.1f} s")
        examples = phase_examples(card)
        say(f"[time] {elapsed():.1f} s")
        timing, full_cases, full_err = phase_timing(card, loops)
        cases, max_err = cases + full_cases, max(max_err, full_err)
        p_timing, full_cases, full_err = phase_timing_packed(card, loops, timing)
        p_cases, p_err = p_cases + full_cases, max(p_err, full_err)
        f_timing, full_cases, full_err = phase_timing_fused(card, loops)
        f_cases, f_err = f_cases + full_cases, max(f_err, full_err)
        pl_timing, pl_cases, pl_err = phase_timing_planes(card, mix, loops,
                                                          timing)
        d_cases += sum(1 for k in pl_timing if k[0] == "dense") * 2
        m_cases += sum(1 for k in pl_timing if k[0] == "mxu") * 2
        d_err, m_err = max(d_err, pl_err), max(m_err, pl_err)
        say(f"[kernel] {cases} bit1, {p_cases} packed, {f_cases} fused, "
            f"{d_cases} dense and {m_cases} mxu kernel-vs-plain cases equal "
            f"in all, max abs err {max(max_err, p_err, f_err, d_err, m_err)}"
            f"  [time {elapsed():.1f} s]")
        sw_timing = phase_sw_timing(card, {
            SW_SHAPE: sw_main["full lattice"]["full"],
            SW_SCALE_SHAPE: sw_main["scale"]["full"]})
        say(f"[time] {elapsed():.1f} s")
        if against:
            phase_against_kernels(card, against)
            say(f"[time] {elapsed():.1f} s")
            phase_turns(against)
            say(f"[time] {elapsed():.1f} s")
    except Failed as e:
        say(f"FAILED: {e}")
        return 1
    finally:
        signal.alarm(0)
        faulthandler.cancel_dump_traceback_later()
    # bit1_sweep and its disorder and replica paths: each entry's launches
    # are those of its own main-path runs; the J-plane path without
    # replicas is the route of -J over row slabs (one device takes split
    # links), its launches those of the [multi] phase.
    entries = [kernel_entry("bit1_sweep", None, timing,
                            sum(r["launches"] for r in ordered.values()),
                            ordered, max_err, info)]
    for path, runs in paths.items():
        entries.append(kernel_entry(
            f"bit1_sweep[{path}]", path, timing,
            sum(r["launches"] for r in runs.values()), runs, max_err, info))
    entries.append(kernel_entry("bit1_sweep[jplanes]", "jplanes", timing, 0,
                                {}, max_err, info))
    # packed_sweep and its J-word and replica paths, likewise
    entries.append(kernel_entry("packed_sweep", None, p_timing,
                                sum(r["launches"] for r in p_ordered.values()),
                                p_ordered, p_err, info, PACKED_KERNEL))
    for path, runs in p_paths.items():
        entries.append(kernel_entry(
            f"packed_sweep[{path}]", path, p_timing,
            sum(r["launches"] for r in runs.values()), runs, p_err, info,
            PACKED_KERNEL))
    # the fused step's two kernels: launches of their own main-path runs
    entries += [fused_entry(var, f_main, f_timing, f_cases, f_err, info)
                for var in FUSED]
    # dense_sweep (ordered and with J planes) and mxu_sweep: launches of
    # their own main-path runs at 8192^2 and 16384^2
    entries.append(plane_kernel_entry(
        "dense_sweep", "dense", None, pl_timing,
        sum(r["launches"] for r in d_ordered.values()), d_ordered, d_err,
        info))
    for path, runs in d_paths.items():
        entries.append(plane_kernel_entry(
            f"dense_sweep[{path}]", "dense", path, pl_timing,
            sum(r["launches"] for r in runs.values()), runs, d_err, info))
    entries.append(plane_kernel_entry(
        "mxu_sweep", "mxu", None, pl_timing,
        sum(r["launches"] for r in m_ordered.values()), m_ordered, m_err,
        info))
    entries += label_entries(sw_main, sw_timing, l_cases, l_err, info)
    # The [multi] phase's launches over row slabs, by entry.
    for e in entries:
        n = multi["launches"].get(e["name"], 0)
        e["launches"] += n
        e["multi_launches"] = n
    missing = set(multi["launches"]) - {e["name"] for e in entries}
    if missing:
        say(f"FAILED: [multi] launches of no kernels line entry: {missing}")
        return 1
    # The [examples] phase's launches, by entry.
    for e in entries:
        n = examples["launches"].get(e["name"], 0)
        e["launches"] += n
        e["examples_launches"] = n
    missing = set(examples["launches"]) - {e["name"] for e in entries}
    if missing:
        say(f"FAILED: [examples] launches of no kernels line entry: "
            f"{missing}")
        return 1
    entries[0]["examples"] = {k: v for k, v in examples.items()
                              if k != "launches"}
    entries[0]["multi_timing"] = multi["timing"]
    kernels = {"kernels": entries}
    say(card["smi"])
    say(json.dumps(kernels))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

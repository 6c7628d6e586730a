"""Run the reference's 8xA100 flagship problem on ONE card.

The reference's largest published run is 524288 x 65536 spins on 8 A100s
(optimized/README.md:318, 4136 flips/ns total). The bit1 backend's 1-bit
storage (4 GiB for 34.4G spins), row-chunked initialization
(lattice.init_store) and word-domain observables put the whole problem —
stepping, magnetization, energy, and the 128-offset correlation — on a
single H100:

    python3 -m ising_tpu_torch.examples.giant_lattice              # 34.4G
    python3 -m ising_tpu_torch.examples.giant_lattice --rows 65536 # 4.3G

The port of the JAX package's examples/giant_lattice.py: its flags,
defaults, storage line and measurement line, on the card unless --device
cpu. Up counts, bond sums and correlation sums are int64 on the device
and Python integers on the host, so nothing wraps past 2^32 spins.
"""

import argparse
import sys
import time

import numpy as np
import torch

from ising_tpu_torch import SimConfig, get_backend, lattice
from ising_tpu_torch.config import resolve_device
from ising_tpu_torch.models import ising
from ising_tpu_torch.parallel import make_sharded_stepper


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=524288)
    ap.add_argument("--cols", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--temp", type=float, default=1.5)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = SimConfig(nrows=args.rows, ncols=args.cols, temp=args.temp,
                    backend="bit1", rng="hw", device=args.device)
    dev = resolve_device(cfg.device)
    be = get_backend(cfg)
    print(f"{cfg.nspins/1e9:.1f}G spins at "
          f"{cfg.nspins/8/2**30:.1f} GiB of storage", flush=True)

    t0 = time.time()
    b, w = lattice.init_store(cfg.seed, cfg.nrows, cfg.ncols, be.encode,
                              device=dev)
    thr = ising.threshold_table(cfg.temperature)
    _, step_n = make_sharded_stepper(cfg, be)
    b, w = step_n(b, w, thr, 0, 1)   # the first launch loads the kernels
    _sync(dev)
    t_init = time.time() - t0
    print(f"init + compile: {t_init:.1f}s", flush=True)

    t0 = time.time()
    b, w = step_n(b, w, thr, 1, args.steps)
    _sync(dev)
    dt = time.time() - t0
    print(f"{args.steps} steps: {dt:.2f}s wall "
          f"({cfg.nspins * args.steps / (dt * 1e9):.1f} flips/ns)",
          flush=True)

    t0 = time.time()
    n_up = int(be.row_up_counts(b, w).sum())
    e = -float(int(be.energy_rows(b, w).sum())) / cfg.nspins
    c = be.corr_rows(b, w, 128).cpu().numpy().astype(np.int64).sum(
        axis=1) / (2.0 * cfg.nspins)
    t_measure = time.time() - t0
    print(f"|m| = {abs(2*n_up-cfg.nspins)/cfg.nspins:.6f}  "
          f"E/N = {e:.6f}  corr[1] = {c[0]:.5f}  corr[128] = {c[127]:.6f}  "
          f"(measure+energy+corr128: {t_measure:.1f}s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Lattice rendering (torch port of ``ising_tpu/utils/plotting.py``, which
replaces the reference's three plotters: basic_cuda/plot_ising.py,
basic_python/plot_ising_multi.py, optimized/plotLattice.py).

matplotlib is imported inside plot_lattice, only when it is called: the
rest of the port runs without it.
"""

from __future__ import annotations

import numpy as np
import torch


def plot_lattice(source, out_path: str = "lattice.png", dpi: int = 150):
    """Render a lattice to PNG.

    `source` may be (black, white) compact planes (torch tensors on any
    device, or numpy), a full +-1 array (a tensor or numpy), or a dump
    file path (hex or txt format auto-detected).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..io import lattice_image, load_lattice

    if isinstance(source, str):
        try:
            b, w = load_lattice(source, fmt="hex", device="cpu")
        except Exception:
            b, w = load_lattice(source, fmt="txt", device="cpu")
        img = lattice_image(b, w)
    elif isinstance(source, tuple):
        img = lattice_image(*(torch.as_tensor(p) for p in source))
    elif torch.is_tensor(source):
        img = source.cpu().numpy()
    else:
        img = np.asarray(source)

    fig, ax = plt.subplots(figsize=(8, 8 * img.shape[0] / img.shape[1]))
    ax.imshow(img, cmap="gray", interpolation="nearest")
    ax.set_axis_off()
    fig.savefig(out_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return out_path

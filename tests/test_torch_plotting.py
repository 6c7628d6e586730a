"""The port's plot_lattice (utils/plotting.py) against the JAX package's:
from compact planes, from a full +-1 array and from hex and txt dumps,
the two draw the same image (the PNGs decode to equal pixels). Needs
matplotlib, which the card's machine lacks: skips without it."""

import numpy as np
import pytest
import torch

from ising_tpu_torch import io as tio
from ising_tpu_torch.lattice import full_to_compact

mpl_image = pytest.importorskip("matplotlib.image")


def _pixels(path):
    return mpl_image.imread(str(path))


@pytest.fixture(scope="module")
def lattice():
    full = np.random.default_rng(11).integers(0, 2, (24, 40)).astype(
        np.uint8)
    return full, full_to_compact(torch.from_numpy(full))


def _both(tmp_path, name, port_source, jax_source):
    from ising_tpu.utils.plotting import plot_lattice as jax_plot
    from ising_tpu_torch.utils.plotting import plot_lattice
    p = tmp_path / f"{name}_port.png"
    j = tmp_path / f"{name}_jax.png"
    assert plot_lattice(port_source, str(p), dpi=40) == str(p)
    jax_plot(jax_source, str(j), dpi=40)
    got, want = _pixels(p), _pixels(j)
    assert got.shape == want.shape and got.shape[0] > 0
    np.testing.assert_array_equal(got, want)
    return got


def test_plot_from_planes_and_array(tmp_path, lattice):
    full, (b, w) = lattice
    spins = 2 * full.astype(np.int8) - 1
    a = _both(tmp_path, "planes", (b, w), (b.numpy(), w.numpy()))
    c = _both(tmp_path, "array", torch.from_numpy(spins), spins)
    np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("fmt", ["hex", "txt"])
def test_plot_from_dump(tmp_path, lattice, fmt):
    full, (b, w) = lattice
    path = tmp_path / f"dump.{fmt}"
    tio.dump_lattice(str(path), b, w, fmt=fmt)
    from_dump = _both(tmp_path, fmt, str(path), str(path))
    spins = 2 * full.astype(np.int8) - 1
    np.testing.assert_array_equal(
        from_dump, _both(tmp_path, f"{fmt}_array", spins, spins))

"""The port's 2-D block decomposition (ising_tpu_torch/parallel/block2d.py)
against the JAX package's (ising_tpu/parallel/block2d.py) and against the
port's own one-device run.

The column-halo neighbour sum and the block draws are held against the
JAX functions at tests/test_block2d.py's geometries; the block stepper
against the port's one-device xla run in every (mode, mesh) case of the
JAX test, and against the JAX stepper on the conftest's 8 virtual CPU
devices in one case a mode. The port's grid on the CPU names the CPU
device once a block. Initial planes are made with numpy from a seed.
Every value compared is an integer: no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ising_tpu import SimConfig as JaxConfig
from ising_tpu import get_backend as jget_backend
from ising_tpu.models import ising as jising
from ising_tpu.ops import xla_ref as jxla
from ising_tpu.parallel import block2d as jb2d
from ising_tpu_torch import SimConfig
from ising_tpu_torch.constants import BLACK, WHITE
from ising_tpu_torch.models import ising
from ising_tpu_torch.ops import get_backend
from ising_tpu_torch.ops import xla_ref
from ising_tpu_torch.parallel import make_sharded_stepper
from ising_tpu_torch.parallel.block2d import (block_draw_words, draws_block,
                                              gather_blocks,
                                              make_block2d_stepper,
                                              make_mesh2d, ring_halo_cols,
                                              split_blocks)
from ising_tpu_torch.rng import MASK, TAG_SWEEP, counter_color_draws

CPU = torch.device("cpu")
MODES = ["philox", "threefry13", "chacha8"]
LANES = {"philox": 4, "threefry13": 2, "chacha8": 16}
# tests/test_block2d.py's block geometries (col0, ncl) of a 32-wide row,
# and its meshes.
GEOMETRIES = [(0, 8), (8, 8), (24, 8), (0, 16), (16, 16), (0, 32), (4, 4)]
MESHES = [(2, 4), (4, 2), (1, 8), (8, 1), (2, 2)]
NROWS, NCOLS, STEPS = 32, 64, 6


def _planes(seed, Y, X):
    gen = np.random.default_rng(seed)
    return tuple(gen.integers(0, 2, (Y, X // 2), dtype=np.uint8)
                 for _ in range(2))


def _one_device(cfg, state, steps, step0=0):
    """The port's one-device xla run from `state`: its planes."""
    _, step_n = make_sharded_stepper(cfg, get_backend(cfg))
    b, w = step_n(*(torch.from_numpy(p.copy()) for p in state),
                  ising.threshold_table(cfg.temperature), step0, steps)
    return b.numpy(), w.numpy()


def _block2d(cfg, mesh_shape, state, steps, step0=0):
    mesh = make_mesh2d(*mesh_shape, device="cpu")
    _, step_n = make_block2d_stepper(cfg, get_backend(cfg), mesh)
    b, w = step_n(split_blocks(state[0], mesh), split_blocks(state[1], mesh),
                  ising.threshold_table(cfg.temperature), step0, steps)
    assert len(b) == mesh_shape[0] and len(b[0]) == mesh_shape[1]
    return gather_blocks(b).numpy(), gather_blocks(w).numpy()


def _cfg(mode, **kw):
    return SimConfig(nrows=NROWS, ncols=NCOLS, temp=1.8, seed=31,
                     backend="xla", rng=mode, device="cpu", **kw)


# -- the column halos --------------------------------------------------------

@pytest.mark.parametrize("color", [BLACK, WHITE])
def test_column_halo_neighbor_sum_matches_jax(color):
    gen = np.random.default_rng(7 + color)
    H, C = 6, 10
    src, up, dn = (gen.integers(0, 2, s, dtype=np.uint8)
                   for s in ((H, C), (1, C), (1, C)))
    left, right = (gen.integers(0, 2, (H, 1), dtype=np.uint8)
                   for _ in range(2))
    want = jxla.neighbor_bit_sum(
        jnp.asarray(src), color=color, H=H, src_up=jnp.asarray(up),
        src_dn=jnp.asarray(dn), src_left=jnp.asarray(left),
        src_right=jnp.asarray(right))
    got = xla_ref.neighbor_bit_sum(
        torch.from_numpy(src), color=color, H=H,
        src_up=torch.from_numpy(up), src_dn=torch.from_numpy(dn),
        src_left=torch.from_numpy(left), src_right=torch.from_numpy(right))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("color", [BLACK, WHITE])
def test_own_edge_columns_as_halos_change_nothing(color):
    """The block's own wrap columns as its halos give the roll's sums."""
    gen = np.random.default_rng(11)
    src = torch.from_numpy(gen.integers(0, 2, (8, 12), dtype=np.uint8))
    rows = dict(src_up=src[-1:], src_dn=src[:1])
    np.testing.assert_array_equal(
        xla_ref.neighbor_bit_sum(src, color=color, H=8, src_left=src[:, -1:],
                                 src_right=src[:, :1], **rows).numpy(),
        xla_ref.neighbor_bit_sum(src, color=color, H=8, **rows).numpy())


def test_ring_halo_cols_are_the_neighbours_edges():
    blocks = [torch.full((4, 3), c, dtype=torch.uint8) for c in range(3)]
    for c, (left, right) in enumerate(ring_halo_cols(blocks)):
        assert left.shape == right.shape == (4, 1)
        assert int(left.unique()) == (c - 1) % 3
        assert int(right.unique()) == (c + 1) % 3
        # one device: views of the neighbours, no copy
        assert left.untyped_storage().data_ptr() == \
            blocks[c - 1].untyped_storage().data_ptr()


def test_split_and_gather_blocks_round_trip():
    plane = _planes(3, 16, 48)[0]
    mesh = make_mesh2d(2, 3, device="cpu")
    grid = split_blocks(plane, mesh)
    assert [[b.shape for b in row] for row in grid] == [[(8, 8)] * 3] * 2
    assert all(b.is_contiguous() for row in grid for b in row)
    np.testing.assert_array_equal(gather_blocks(grid).numpy(), plane)


# -- the block draws ---------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("col0,ncl", GEOMETRIES)
def test_draws_block_matches_jax_and_the_full_row(mode, col0, ncl):
    ch, rows, row0 = 32, 6, 10
    g = ch // LANES[mode]
    kw = dict(step=3, tag=TAG_SWEEP | 1, row0=row0, col0=col0, ch_global=ch)
    if not (ncl % g == 0 or g % ncl == 0):
        with pytest.raises(ValueError) as want:
            jb2d.draws_block(mode, 999, rows, ncl, **kw)
        with pytest.raises(ValueError) as got:
            draws_block(mode, 999, rows, ncl, **kw)
        assert str(got.value) == str(want.value)
        return
    blk = draws_block(mode, 999, rows, ncl, **kw).numpy()
    full = counter_color_draws(mode, 999, rows, ch, step=3,
                               tag=TAG_SWEEP | 1, row0=row0,
                               row_stride=ch).numpy()
    np.testing.assert_array_equal(blk, full[:, col0:col0 + ncl])
    np.testing.assert_array_equal(
        blk, np.asarray(jb2d.draws_block(mode, 999, rows, ncl, **kw)))


@pytest.mark.parametrize("mode", MODES)
def test_draws_block_where_rows_and_counters_wrap(mode):
    """Global rows past 2^32 - 1 wrap to 0, and the counters' low words
    carry, as in the full-row draws and the JAX package."""
    ch, rows, row0 = 64, 6, MASK - 2
    g = ch // LANES[mode]
    for col0, ncl in ((0, g), (g, g), (0, ch)):
        kw = dict(step=MASK, tag=TAG_SWEEP, row0=row0, col0=col0,
                  ch_global=ch)
        blk = draws_block(mode, 5, rows, ncl, **kw).numpy()
        full = counter_color_draws(mode, 5, rows, ch, step=MASK,
                                   tag=TAG_SWEEP, row0=row0,
                                   row_stride=ch).numpy()
        np.testing.assert_array_equal(blk, full[:, col0:col0 + ncl])
        np.testing.assert_array_equal(
            blk, np.asarray(jb2d.draws_block(mode, 5, rows, ncl, **kw)))


@pytest.mark.parametrize("mode", MODES)
def test_block_draw_words_count_the_lane_redundancy(mode):
    """A column split of C blocks generates min(LANES, C) times one
    device's words: LANES where a block sits inside one lane group, C
    where blocks hold whole lane groups."""
    ch, H = 256, 16
    one = H * ch
    lanes = LANES[mode]
    for C in (1, 2, 4, 8, 16, 32):
        words = C * block_draw_words(mode, H, ch // C, ch)
        assert words == min(lanes, C) * one, (C, words)


# -- the stepper -------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_block2d_matches_one_device(mode, mesh_shape):
    """Trajectories over the grid == the port's one-device run, bit for
    bit, both planes."""
    cfg = _cfg(mode)
    state = _planes(31, NROWS, NCOLS)
    want = _one_device(cfg, state, STEPS)
    got = _block2d(cfg, mesh_shape, state, STEPS)
    for g, w, what in zip(got, want, ("black", "white")):
        np.testing.assert_array_equal(g, w, err_msg=f"{mode} {mesh_shape} "
                                      f"{what}")


@pytest.mark.parametrize("mode,mesh_shape", [("philox", (2, 4)),
                                             ("threefry13", (4, 2)),
                                             ("chacha8", (1, 8))])
def test_block2d_matches_jax_block2d(mode, mesh_shape):
    """The port's grid against the JAX make_block2d_stepper on 8 virtual
    CPU devices, from the same numpy planes."""
    state = _planes(41, NROWS, NCOLS)
    jcfg = JaxConfig(nrows=NROWS, ncols=NCOLS, temp=1.8, seed=31,
                     backend="xla", rng=mode)
    sh, jstep = jb2d.make_block2d_stepper(jcfg, jget_backend(jcfg),
                                          jb2d.make_mesh2d(*mesh_shape))
    thr = jnp.asarray(jising.threshold_table(jcfg.temperature))
    jb, jw = jstep(jax.device_put(state[0], sh["plane"]),
                   jax.device_put(state[1], sh["plane"]), thr,
                   jnp.uint32(0), STEPS)
    got = _block2d(_cfg(mode), mesh_shape, state, STEPS)
    np.testing.assert_array_equal(got[0], np.asarray(jb))
    np.testing.assert_array_equal(got[1], np.asarray(jw))


@pytest.mark.parametrize("mode", MODES)
def test_block2d_steps_wrap_mod_2_32(mode):
    """step0 + i wraps mod 2^32 as the one-device loop's does."""
    cfg = _cfg(mode)
    state = _planes(5, NROWS, NCOLS)
    want = _one_device(cfg, state, 4, step0=MASK - 1)
    got = _block2d(cfg, (2, 2), state, 4, step0=MASK - 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_block2d_at_zero_temperature():
    cfg = SimConfig(nrows=NROWS, ncols=NCOLS, temp=0.0, seed=3,
                    backend="xla", rng="philox", device="cpu")
    state = _planes(9, NROWS, NCOLS)
    want = _one_device(cfg, state, 3)
    got = _block2d(cfg, (2, 4), state, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- the mesh and the scope fences -------------------------------------------

def test_make_mesh2d_on_the_cpu_and_explicit_lists():
    assert make_mesh2d(2, 3, device="cpu") == [[CPU] * 3] * 2
    assert make_mesh2d(1, 2, devices=["cpu"] * 5) == [[CPU, CPU]]
    with pytest.raises(ValueError) as got:
        make_mesh2d(3, 3, devices=[CPU] * 8)
    with pytest.raises(ValueError) as want:
        jb2d.make_mesh2d(3, 3)
    assert str(got.value) == str(want.value) == \
        "mesh 3x3 needs 9 devices, only 8 present"


def _stepper_fence(kw, mesh_shape):
    """The error of each package's make_block2d_stepper for one config."""
    errors = []
    for make, conf, backend, mesh in (
            (jb2d.make_block2d_stepper, JaxConfig, jget_backend,
             lambda: jb2d.make_mesh2d(*mesh_shape)),
            (make_block2d_stepper, lambda **k: SimConfig(device="cpu", **k),
             get_backend, lambda: make_mesh2d(*mesh_shape, device="cpu"))):
        cfg = conf(**{"nrows": NROWS, "ncols": NCOLS, "temp": 1.8, **kw})
        with pytest.raises((NotImplementedError, ValueError)) as e:
            make(cfg, backend(cfg), mesh())
        errors.append(e)
    return errors


@pytest.mark.parametrize("kw,mesh_shape", [
    (dict(backend="packed"), (2, 2)),
    (dict(backend="xla", xsl=16, ysl=16), (2, 2)),
    (dict(backend="xla", j_prob=0.3), (2, 2)),
    (dict(backend="xla", field=0.1), (2, 2)),
    (dict(backend="xla", nrows=24), (8, 1)),
    (dict(backend="xla", nrows=36), (8, 1)),
    (dict(backend="xla"), (1, 3)),
])
def test_stepper_fences_match_jax(kw, mesh_shape):
    want, got = _stepper_fence(kw, mesh_shape)
    assert got.type is want.type
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode,ncl,ch", [
    ("hw", 8, 32),          # no counter contract
    ("philox", 8, 30),      # compact width % LANES
    ("chacha8", 8, 40),
    ("philox", 3, 32),      # ncl does not divide g = 8
    ("threefry13", 24, 32),  # ncl > g = 16, not a multiple
])
def test_draw_fences_match_jax(mode, ncl, ch):
    kw = dict(step=0, tag=0, row0=0, col0=0, ch_global=ch)
    with pytest.raises((NotImplementedError, ValueError)) as want:
        jb2d.draws_block(mode, 1, 4, ncl, **kw)
    with pytest.raises((NotImplementedError, ValueError)) as got:
        draws_block(mode, 1, 4, ncl, **kw)
    assert got.type is want.type
    assert str(got.value) == str(want.value)


def test_draws_block_needs_an_aligned_column_offset():
    """A block offset that is not a multiple of its width could straddle
    a lane group; the port's col0 is a host int, so it is checked."""
    with pytest.raises(ValueError, match="offset 4 must be a multiple of "
                                         "its width 8"):
        draws_block("philox", 1, 4, 8, step=0, tag=0, row0=0, col0=4,
                    ch_global=32)


@pytest.mark.parametrize("mode", ["chacha8b", "philox7b", "threefry13b"])
def test_bit_plane_modes_are_refused(mode):
    """The port refuses the ...b modes with the wording the JAX package
    gives them (its draws_block lets them through: the next test)."""
    with pytest.raises(NotImplementedError, match="counter contracts"):
        draws_block(mode, 1, 4, 8, step=0, tag=0, row0=0, col0=0,
                    ch_global=32)
    with pytest.raises(NotImplementedError, match="counter contracts"):
        make_block2d_stepper(_cfg(mode), get_backend(_cfg(mode)),
                             make_mesh2d(2, 2, device="cpu"))


def test_jax_block2d_in_a_bit_plane_mode_leaves_one_device():
    """JAX fault: in a ...b mode the JAX block2d stepper sweeps with u32
    draws, while the xla backend on one device takes the bit-plane
    contract (the port's one-device run, equal to the JAX package's since
    tests/test_torch_xla.py), so the two trajectories part. The port
    refuses the mode (the test above)."""
    state = _planes(13, NROWS, NCOLS)
    jcfg = JaxConfig(nrows=NROWS, ncols=NCOLS, temp=1.8, seed=31,
                     backend="xla", rng="threefry13b")
    thr = jnp.asarray(jising.threshold_table(jcfg.temperature))
    sh, step2 = jb2d.make_block2d_stepper(jcfg, jget_backend(jcfg),
                                          jb2d.make_mesh2d(2, 2))
    two = step2(jax.device_put(state[0], sh["plane"]),
                jax.device_put(state[1], sh["plane"]), thr, jnp.uint32(0), 2)
    one = _one_device(_cfg("threefry13b"), state, 2)
    assert not np.array_equal(one[0], np.asarray(two[0]))
    # the JAX grid followed the u32 contract of the same family instead
    u32 = _one_device(_cfg("threefry13"), state, 2)
    np.testing.assert_array_equal(u32[0], np.asarray(two[0]))

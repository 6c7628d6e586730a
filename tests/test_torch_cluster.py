"""The port's Swendsen-Wang (ising_tpu_torch/cluster.py) against the JAX
package's (ising_tpu/cluster.py), bit for bit.

The same inputs, made with numpy from a seed, go through both packages:
the bond thresholds and bonds, the plain labelers (against the JAX
labelers, the JAX tiled labeler in Pallas interpret mode, and a union-find
here), one pass of the JAX tiled labeler's plain record and the port's
tile-local phase (against union-finds over the bonds inside each tile),
the hooks across tiles in shuffled orders, clusters that snake through
many tiles and replicas larger than a tile, the coins and the ghost,
sw_step with and without replicas and a field, whole SwendsenWang runs
and the CLI. Every value compared is an integer or a bit, so every
comparison is exact. The CUDA labeler is held against its plain phases on
the card (the gpu-marked test below, and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ising_tpu import SimConfig as JaxConfig
from ising_tpu import cli as jcli
from ising_tpu import cluster as jc
from ising_tpu.lattice import compact_to_full as jax_compact_to_full
from ising_tpu.rng import color_draws as jax_color_draws
from ising_tpu_torch import cli, cluster
from ising_tpu_torch.config import SimConfig
from ising_tpu_torch.constants import TCRIT
from ising_tpu_torch.rng import TAG_CLUSTER, color_draws

from test_cluster import uf_labels


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bonds(seed, Y, X, p):
    rs = np.random.RandomState(seed)
    return rs.rand(Y, X) < p, rs.rand(Y, X) < p


def _batch(a, ysl, xsl):
    Y, X = a.shape
    return (a.reshape(Y // ysl, ysl, X // xsl, xsl).transpose(0, 2, 1, 3)
            .reshape(-1, ysl, xsl))


def _jax_replica_labels(o_r, o_d, ysl, xsl):
    """The JAX package's replica labels (cluster.py:453-462), in natural
    layout: vmap(label_clusters) over the replica batch plus rep*ysl*xsl."""
    Y, X = o_r.shape
    lab = np.asarray(jax.vmap(jc.label_clusters)(
        jnp.asarray(_batch(o_r, ysl, xsl)), jnp.asarray(_batch(o_d, ysl, xsl))))
    lab = lab + np.arange(lab.shape[0])[:, None, None] * (ysl * xsl)
    nry, nrx = Y // ysl, X // xsl
    return lab.reshape(nry, nrx, ysl, xsl).transpose(0, 2, 1, 3).reshape(Y, X)


@pytest.mark.parametrize("temp", [-1.0, 0.0, 0.5, 1.0, TCRIT, 2.5, 10.0])
@pytest.mark.parametrize("coupling", [1.0, 0.1, 0.3, 0.0])
def test_bond_threshold_matches_jax(temp, coupling):
    assert cluster.bond_threshold(temp, coupling) == \
        jc.bond_threshold(temp, coupling)
    if temp <= 0:
        assert cluster.bond_threshold(temp, coupling) == 0xFFFFFFFF


@pytest.mark.parametrize("Y,X,ysl,xsl", [(16, 24, None, None),
                                         (16, 24, 8, 12), (12, 32, 4, 8)])
@pytest.mark.parametrize("temp", [TCRIT, 0.0])
def test_open_bonds_match_jax(Y, X, ysl, xsl, temp):
    """The bond draws (full width, TAG_CLUSTER streams), the aligned pairs
    and the unsigned compare; with replicas the JAX formula of
    sw_step_replica (cluster.py:434-443), the wrap inside each replica."""
    full = np.random.RandomState(3).randint(0, 2, (Y, X)).astype(np.uint8)
    thr = cluster.bond_threshold(temp)
    dr, dd = (color_draws(9, Y, X, step=5, tag=TAG_CLUSTER | c, row_stride=X)
              for c in (0, 1))
    jdr, jdd = (np.asarray(jax_color_draws(9, Y, X, step=jnp.uint32(5),
                                           tag=TAG_CLUSTER | c, row_stride=X))
                for c in (0, 1))
    np.testing.assert_array_equal(dr.numpy(), jdr)
    got = cluster.open_bonds(_t(full), dr, dd, thr, ysl=ysl, xsl=xsl)
    if ysl is None:
        want = jc.open_bonds(jnp.asarray(full), jdr, jdd, thr)
    else:
        nry, nrx = Y // ysl, X // xsl
        right = np.roll(full.reshape(Y, nrx, xsl), -1, 2).reshape(Y, X)
        down = np.roll(full.reshape(nry, ysl, X), -1, 1).reshape(Y, X)
        want = ((full == right) & (jdr <= thr), (full == down) & (jdd <= thr))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if temp <= 0:   # p = 1 opens every aligned bond
        assert got[0].sum() == (full == np.roll(full, -1, 1)).sum() \
            or ysl is not None
    ob = cluster.draw_bonds(_t(full), thr, 9, 5, ysl=ysl, xsl=xsl)
    for g, w in zip(ob[:2], got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", [(12, 16), (10, 24), (24, 8), (33, 40)])
@pytest.mark.parametrize("p", [0.0, 0.2, 0.585, 1.0])
def test_label_clusters_match_jax_and_union_find(shape, p):
    o_r, o_d = _bonds(hash((shape, p)) % 1000, *shape, p)
    want = uf_labels(o_r, o_d)
    np.testing.assert_array_equal(
        np.asarray(jc.label_clusters(jnp.asarray(o_r), jnp.asarray(o_d))),
        want)
    got = cluster.label_clusters(_t(o_r), _t(o_d))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    tiled, passes = cluster.label_clusters_tiled_reference(
        _t(o_r), _t(o_d), tile=(5, 8))
    np.testing.assert_array_equal(tiled.numpy(), want)
    np.testing.assert_array_equal(
        cluster.label_clusters_tiled(_t(o_r), _t(o_d), tile=(5, 8)).numpy(),
        want)


@pytest.mark.parametrize("shape,p", [((128, 128), 0.585), ((64, 256), 0.585),
                                     ((128, 256), 1.0)])
def test_labelers_match_jax_tiled_labeler(shape, p):
    """The JAX Pallas labeler in interpret mode (its TPU path) reaches the
    port's labels, from the port's default tiles and from others."""
    o_r, o_d = _bonds(17, *shape, p)
    want = np.asarray(jc.label_clusters_tiled(jnp.asarray(o_r),
                                              jnp.asarray(o_d),
                                              interpret=True))
    got = cluster.label_clusters_tiled(_t(o_r), _t(o_d))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        cluster.label_clusters_tiled(_t(o_r), _t(o_d), tile=(16, 48)).numpy(),
        want)


@pytest.mark.parametrize("Y,X,ysl,xsl", [(32, 64, 16, 16), (32, 64, 8, 32),
                                         (24, 36, 12, 12), (64, 64, 64, 32)])
@pytest.mark.parametrize("p", [0.3, 0.585, 1.0])
def test_replica_labels_match_jax(Y, X, ysl, xsl, p):
    """Replica ids (rep * ysl * xsl + the id inside the replica), not flat
    positions; one launch where the tiles hold whole replicas, and the same
    labels from tiles that cut the replicas (three launches, and the JAX
    labeler's passes)."""
    o_r, o_d = _bonds(Y + X + ysl, Y, X, p)
    want = _jax_replica_labels(o_r, o_d, ysl, xsl)
    geo = dict(ysl=ysl, xsl=xsl)
    np.testing.assert_array_equal(
        cluster.label_clusters(_t(o_r), _t(o_d), **geo).numpy(), want)
    got, stats = cluster.label_clusters_tiled(_t(o_r), _t(o_d),
                                              return_stats=True, **geo)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats == {"launches": 1}
    cut = (ysl // 2, xsl // 2)
    got, passes = cluster.label_clusters_tiled_reference(_t(o_r), _t(o_d),
                                                         tile=cut, **geo)
    np.testing.assert_array_equal(got.numpy(), want)
    got, stats = cluster.label_clusters_tiled(_t(o_r), _t(o_d), tile=cut,
                                              return_stats=True, **geo)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats == {"launches": 3}


def _tile_union_find(o_r, o_d, tile, ysl, xsl, across=None):
    """(roots, find): a union-find over the open bonds inside each tile,
    linking the larger root under the smaller, so that every root is its
    tile component's least position. across(a, b) is called for each open
    bond that leaves a tile."""
    Y, X = o_r.shape
    ty, tx = tile
    parent = list(range(Y * X))

    def find(i):
        while parent[i] != i:
            i = parent[i]
        return i

    for y in range(Y):
        for x in range(X):
            xr = x + 1 if (x + 1) % xsl else x + 1 - xsl
            yd = y + 1 if (y + 1) % ysl else y + 1 - ysl
            for is_open, (y2, x2) in ((o_r[y, x], (y, xr)),
                                      (o_d[y, x], (yd, x))):
                if not is_open:
                    continue
                a, b = y * X + x, y2 * X + x2
                if (y // ty, x // tx) == (y2 // ty, x2 // tx):
                    ra, rb = find(a), find(b)
                    parent[max(ra, rb)] = min(ra, rb)
                elif across is not None:
                    across(a, b)
    return [find(i) for i in range(Y * X)], find


def _uf_local_pass(lab, o_r, o_d, tile, ysl, xsl):
    """One pass by a union-find over the bonds inside each tile, after the
    pull across the bonds that leave it."""
    Y, X = o_r.shape
    stepped = lab.reshape(-1).astype(np.int64).copy()
    flat = stepped.copy()

    def pull(a, b):
        stepped[a] = min(stepped[a], flat[b])
        stepped[b] = min(stepped[b], flat[a])

    roots, _ = _tile_union_find(o_r, o_d, tile, ysl, xsl, pull)
    least = {}
    for i, r in enumerate(roots):
        least[r] = min(least.get(r, stepped[i]), stepped[i])
    return np.array([least[r] for r in roots]).reshape(Y, X)


@pytest.mark.parametrize("Y,X,ysl,xsl,tile", [
    (24, 40, 24, 40, (10, 16)),     # tiles cut short at both edges
    (24, 40, 24, 40, (24, 40)),     # one tile: the wraps inside it
    (24, 40, 12, 20, (12, 20)),     # a replica a tile
    (24, 40, 12, 20, (6, 10)),      # tiles inside the replicas
    (16, 48, 8, 16, (8, 48)),       # three replicas a tile
])
@pytest.mark.parametrize("p", [0.0, 0.585, 1.0])
def test_local_pass_matches_tile_union_find(Y, X, ysl, xsl, tile, p):
    """The JAX pass's plain record from the ids and from in-cluster labels,
    and the port's tile-local phase (plain, and through the wrapper on CPU
    tensors, positions and ids), against union-finds over the bonds inside
    each tile."""
    o_r, o_d = _bonds(Y * X + tile[0], Y, X, p)
    ids = cluster.site_ids(Y, X, ysl=ysl, xsl=xsl).numpy()
    rs = np.random.RandomState(1)
    full_labels = cluster.label_clusters(_t(o_r), _t(o_d), ysl=ysl,
                                         xsl=xsl).numpy()
    in_cluster = np.where(rs.rand(Y, X) < 0.5, full_labels, ids)
    geo = dict(tile=tile, ysl=ysl, xsl=xsl)
    for lab in (None, in_cluster):
        src = ids if lab is None else lab
        want = _uf_local_pass(src, o_r, o_d, tile, ysl, xsl)
        got = cluster.local_pass_reference(
            None if lab is None else _t(lab.astype(np.int32)), _t(o_r),
            _t(o_d), **geo)
        np.testing.assert_array_equal(got.numpy(), want)
    roots, _ = _tile_union_find(o_r, o_d, tile, ysl, xsl)
    roots = np.array(roots).reshape(Y, X)
    for use_ids in (False, True):
        want = ids.reshape(-1)[roots] if use_ids else roots
        np.testing.assert_array_equal(cluster.tile_roots_reference(
            _t(o_r), _t(o_d), ids=use_ids, **geo).numpy(), want)
        out = torch.empty((Y, X), dtype=torch.int32)
        assert cluster.tile_roots(_t(o_r), _t(o_d), out, ids=use_ids,
                                  **geo) is out
        np.testing.assert_array_equal(out.numpy(), want)


def test_site_ids_and_tiles():
    ids = cluster.site_ids(4, 8, ysl=2, xsl=4).numpy()
    np.testing.assert_array_equal(ids[:2], [[0, 1, 2, 3, 8, 9, 10, 11],
                                            [4, 5, 6, 7, 12, 13, 14, 15]])
    assert ids[2, 0] == 16 and ids[3, 7] == 31
    np.testing.assert_array_equal(cluster.site_ids(3, 4).numpy(),
                                  np.arange(12).reshape(3, 4))
    assert cluster.pick_tile(4096, 4096) == (64, 128)
    assert cluster.pick_tile(200, 328) == (64, 128)
    assert cluster.pick_tile(64, 64) == (64, 64)
    assert cluster.pick_tile(4096, 4096, ysl=128, xsl=128) == (128, 128)
    assert cluster.pick_tile(4096, 4096, ysl=16, xsl=16) == (64, 128)
    assert cluster.pick_tile(1024, 1024, ysl=32, xsl=64) == (64, 128)
    assert cluster.pick_tile(1024, 1024, ysl=512, xsl=256) == (64, 128)
    assert cluster.pick_tile(256, 1024, ysl=64, xsl=64) == (64, 128)
    for shape, geo in (((4096, 4096), {}), ((200, 328), {}),
                       ((1024, 1024), dict(ysl=512, xsl=256)),
                       ((96, 80), dict(ysl=48, xsl=40))):
        ty, tx = cluster.pick_tile(*shape, **geo)
        assert ty * tx <= cluster.MAX_TILE_SITES


def test_label_pass_checks_its_arguments():
    """The three phase wrappers check device, dtype, shape, contiguity,
    aliasing, replicas, the tile and Y * X < 2^31 before anything runs."""
    o = torch.ones((8, 16), dtype=torch.bool)
    out = torch.empty((8, 16), dtype=torch.int32)
    kw = dict(tile=(8, 16))
    for phase in (cluster.tile_roots, cluster.hook_roots):
        for args, extra, err, msg in (
                ((o.to(torch.uint8), o, out), {}, TypeError, "bool"),
                ((o, o, out.to(torch.int64)), {}, TypeError, "int32"),
                ((o, o[:4], out), {}, ValueError, "shape"),
                ((o, o, out), dict(tile=(9, 16)), ValueError, "tile"),
                ((o, o, out), dict(tile=(8, 0)), ValueError, "tile"),
                ((o, o, out), dict(ysl=3), ValueError, "replicas"),
                ((o, o, out.view(torch.bool)[:, :16]), {}, TypeError,
                 "int32"),
                ((o, o, torch.empty((8, 32), dtype=torch.int32)[:, ::2]), {},
                 ValueError, "contiguous")):
            with pytest.raises(err, match=msg):
                phase(*args, **{**kw, **extra})
    words = torch.zeros((8, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="overlap"):
        cluster.tile_roots(words.view(torch.bool).reshape(-1)[:128]
                           .view(8, 16), o, words, **kw)
    for args, extra, err, msg in (
            ((out, out), dict(ysl=4), ValueError, "overlap"),
            ((out, out[:4]), {}, ValueError, "shape"),
            ((out.to(torch.int64), out), {}, TypeError, "int32"),
            ((out, out), dict(xsl=5), ValueError, "replicas"),
            ((out, out), dict(tile=(8, 32)), ValueError, "tile")):
        with pytest.raises(err, match=msg):
            cluster.flatten_roots(*args, **{**kw, **extra})
    big = torch.ones((1, 1), dtype=torch.bool).expand(1 << 16, 1 << 15)
    with pytest.raises(ValueError, match="2\\^31"):
        cluster.tile_roots(big, big, big, tile=(8, 8))
    with pytest.raises(ValueError, match="2\\^31"):
        cluster.flatten_roots(big, big, tile=(8, 8))


@pytest.mark.parametrize("shape,tile,launches", [
    ((96, 160), (16, 32), 3), ((96, 160), (5, 8), 3),
    ((96, 160), (96, 160), 1)])
def test_tiled_labeling_counts_passes_and_reads(shape, tile, launches):
    """The labels of the JAX labeler's passes (label_clusters_tiled_
    reference) in 3 launches, or 1 where one tile holds the lattice; the
    JAX labeler needs several passes where tiles cut it."""
    o_r, o_d = _bonds(4, *shape, 0.585)
    want, passes = cluster.label_clusters_tiled_reference(
        _t(o_r), _t(o_d), tile=tile)
    assert passes > 3 if launches == 3 else passes == 1
    got, stats = cluster.label_clusters_tiled(_t(o_r), _t(o_d), tile=tile,
                                              return_stats=True)
    assert torch.equal(got, want)
    assert stats == {"launches": launches}


def _snake(Y, X):
    """Bonds of one cluster that snakes through the lattice: every row open
    along its length but for the periodic wrap, joined to the next row at
    alternate ends (the worst chain of tile roots for the hooks)."""
    o_r = np.ones((Y, X), bool)
    o_r[:, -1] = False
    o_d = np.zeros((Y, X), bool)
    o_d[0:Y - 1:2, -1] = True
    o_d[1:Y - 1:2, 0] = True
    return o_r, o_d


@pytest.mark.parametrize("Y,X,tile", [(64, 96, (4, 8)), (64, 96, (1, 96)),
                                      (40, 36, (3, 5)), (128, 256, None)])
def test_snaking_cluster_through_many_tiles(Y, X, tile):
    """One cluster through every tile (and, cut once, two), labelled by the
    JAX labeler and the port's phases alike."""
    o_r, o_d = _snake(Y, X)
    for cut in (False, True):
        if cut:
            o_d[Y // 2 - 1] = False   # the halves meet nowhere else
        want = np.asarray(jc.label_clusters(jnp.asarray(o_r),
                                            jnp.asarray(o_d)))
        assert len(np.unique(want)) == 1 + cut
        got, stats = cluster.label_clusters_tiled(_t(o_r), _t(o_d), tile=tile,
                                                  return_stats=True)
        np.testing.assert_array_equal(got.numpy(), want)
        assert stats == {"launches": 3}


@pytest.mark.parametrize("Y,X,ysl,xsl,tile", [
    (64, 64, 32, 64, (8, 16)), (64, 64, 64, 32, (16, 8)),
    (256, 256, 256, 128, None), (48, 60, 24, 30, (10, 7))])
@pytest.mark.parametrize("p", [0.3, 0.585, 1.0])
def test_replicas_larger_than_a_tile(Y, X, ysl, xsl, tile, p):
    """Replicas cut by the tiles (by pick_tile where a replica exceeds
    MAX_TILE_SITES): their wraps cross tiles and are hooked across them;
    the labels are the JAX package's replica ids."""
    geo = dict(ysl=ysl, xsl=xsl)
    tile = tile or cluster.pick_tile(Y, X, **geo)
    assert not cluster.whole_replica_tiles((Y, X), tile, **geo)
    o_r, o_d = _bonds(Y + X + int(10 * p), Y, X, p)
    want = _jax_replica_labels(o_r, o_d, ysl, xsl)
    got, stats = cluster.label_clusters_tiled(_t(o_r), _t(o_d), tile=tile,
                                              return_stats=True, **geo)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats == {"launches": 3}


def _kernel_hooks(parent, cross, order, jumps):
    """The hook kernel's union-find, one bond at a time in `order`: find
    both roots (with jumps, each visited node jumps to its grandparent, as
    find_root does), hook the larger root under the smaller; then every
    site's root."""
    parent = parent.copy()

    def find(i):
        prev, cur = i, parent[i]
        while parent[cur] != cur:
            nxt = parent[cur]
            if jumps:
                parent[prev] = nxt
            prev, cur = cur, nxt
        return cur

    for k in order:
        a, b = find(cross[k][0]), find(cross[k][1])
        if a != b:
            parent[max(a, b)] = min(a, b)
    return np.array([find(i) for i in range(parent.size)])


@pytest.mark.parametrize("Y,X,ysl,xsl,tile", [
    (24, 40, None, None, (5, 8)), (24, 40, 12, 20, (10, 16)),
    (32, 32, None, None, (4, 4))])
@pytest.mark.parametrize("p", [0.5, 0.585, 1.0])
def test_hooks_in_any_order_give_the_same_labels(Y, X, ysl, xsl, tile, p):
    """The card's hooks run in no fixed order: every order of the bonds
    that leave a tile, with or without the grandparent jumps, reaches the
    same roots, and hook_reference's flattened forest and the flatten give
    label_clusters' labels."""
    o_r, o_d = _bonds(Y * 7 + X, Y, X, p)
    geo = dict(ysl=ysl, xsl=xsl)
    want = cluster.label_clusters(_t(o_r), _t(o_d), **geo).numpy()
    crossing = []
    _, _, ysl_, xsl_ = cluster._sizes((Y, X), ysl, xsl)
    _tile_union_find(o_r, o_d, tile, ysl_, xsl_,
                     lambda a, b: crossing.append((a, b)))
    assert crossing
    parent = cluster.tile_roots_reference(_t(o_r), _t(o_d), tile=tile, **geo)
    ids = cluster.site_ids(Y, X, **geo).reshape(-1).numpy()
    rs = np.random.RandomState(5)
    for trial in range(6):
        order = rs.permutation(len(crossing))
        roots = _kernel_hooks(parent.reshape(-1).numpy(), crossing, order,
                              jumps=trial % 2 == 0)
        np.testing.assert_array_equal(ids[roots].reshape(Y, X), want)
    hooked = cluster.hook_reference(parent, _t(o_r), _t(o_d), tile=tile,
                                    **geo)
    np.testing.assert_array_equal(
        cluster.flatten_reference(hooked, **geo).numpy(), want)
    np.testing.assert_array_equal(
        cluster.flatten_reference(parent, **geo).numpy(),
        ids[parent.reshape(-1).numpy()].reshape(Y, X))


@pytest.mark.parametrize("Y,X,ysl,xsl", [(16, 24, None, None), (16, 24, 8, 8)])
def test_coins_and_ghost_match_jax(Y, X, ysl, xsl):
    o_r, o_d = _bonds(8, Y, X, 0.5)
    if ysl is None:
        lab = cluster.label_clusters(_t(o_r), _t(o_d))
        jlab = jc.label_clusters(jnp.asarray(o_r), jnp.asarray(o_d))
    else:
        lab = cluster.label_clusters(_t(o_r), _t(o_d), ysl=ysl, xsl=xsl)
        jlab = jnp.asarray(_jax_replica_labels(o_r, o_d, ysl, xsl))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    for step in (0, 7, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            cluster.cluster_coins(lab, 11, step).numpy(),
            np.asarray(jc.cluster_coins(jlab, 11, jnp.uint32(step))))
    ghost = np.random.RandomState(2).rand(Y, X) < 0.05
    got = cluster.ghost_bonded_clusters(lab, _t(ghost))
    assert got.dtype == torch.uint8 and got.any()
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jc.ghost_bonded_clusters(jlab, jnp.asarray(ghost))))


@pytest.mark.parametrize("replicas,temp,field", [
    (None, TCRIT, 0.0), (None, TCRIT, 0.3), (None, 0.0, -0.3),
    (None, 0.0, 0.0), ((8, 16), TCRIT, 0.0), ((8, 16), TCRIT, -0.3),
    ((8, 16), 0.0, 0.3)])
def test_sw_step_matches_jax(replicas, temp, field):
    """sw_step over 3 updates against the JAX sw_step (full lattice) or
    sw_step_replica (ysl, xsl), at Tc and T = 0, the ghost at h = +-0.3."""
    Y, X = 16, 32
    full = np.random.RandomState(6).randint(0, 2, (Y, X)).astype(np.uint8)
    thr = cluster.bond_threshold(temp)
    tg = cluster.bond_threshold(temp, abs(field))
    sgn = float(np.sign(field))
    geo = {} if replicas is None else dict(ysl=replicas[0], xsl=replicas[1])
    got, want = _t(full), jnp.asarray(full)
    for step in range(3):
        got = cluster.sw_step(got, thr, 21, step, field=field, thr_ghost=tg,
                              **geo)
        if replicas is None:
            want = jc.sw_step(want, jnp.uint32(thr), 21, jnp.uint32(step),
                              field=sgn, thr_ghost=jnp.uint32(tg))
        else:
            want = jc.sw_step_replica(want, jnp.uint32(thr), 21,
                                      jnp.uint32(step), field=sgn,
                                      thr_ghost=jnp.uint32(tg), **geo)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _pair(**kw):
    base = dict(nrows=16, ncols=32, seed=5, backend="xla")
    base.update(kw)
    return (cluster.SwendsenWang(SimConfig(device="cpu", **base)),
            jc.SwendsenWang(JaxConfig(**base)))


def _assert_same(port, jax_sw):
    np.testing.assert_array_equal(port.full.numpy(), np.asarray(jax_sw.full))
    assert port.measure() == jax_sw.measure()
    assert port.energy() == jax_sw.energy()
    assert port.step == jax_sw.step


@pytest.mark.parametrize("kw", [dict(temp=TCRIT), dict(temp=1.8, field=0.3),
                                dict(temp=2.6, xsl=16, ysl=8),
                                dict(temp=0.0, xsl=8, ysl=8, field=-0.2)])
def test_swendsen_wang_runs_match_jax(kw):
    """Up counts, energy() and the replica |m| after advance, through a
    temperature ramp and a field that changes sign."""
    port, jax_sw = _pair(**kw)
    _assert_same(port, jax_sw)
    for sw in (port, jax_sw):
        sw.advance(2)
    _assert_same(port, jax_sw)
    for sw in (port, jax_sw):
        sw.set_temperature(sw.temp + 0.4)
        sw.set_field(-0.25 if kw.get("field", 0.0) >= 0 else 0.25)
        sw.advance(2)
        sw.set_field(0.0)
        sw.advance(1)
    _assert_same(port, jax_sw)
    assert port.cfg.field == jax_sw.cfg.field == 0.0
    if "xsl" in kw:
        np.testing.assert_array_equal(port.replica_magnetizations(),
                                      jax_sw.replica_magnetizations())
    b, w = port.bits()
    jb, jw = jax_sw.bits()
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert sum(port.launch_counts.values()) == 5


@pytest.mark.parametrize("kw", [dict(nrows=128, ncols=256, temp=TCRIT),
                                dict(nrows=256, ncols=256, temp=2.0,
                                     xsl=128, ysl=256, field=0.1)])
def test_sw_runs_match_jax_where_tiles_cut_the_replicas(kw):
    """Lattices and replicas larger than a tile (MAX_TILE_SITES): every
    update takes the three phases, and the trajectory is the JAX
    package's."""
    port, jax_sw = _pair(**kw)
    for sw in (port, jax_sw):
        sw.advance(3)
    _assert_same(port, jax_sw)
    assert port.launch_counts == {3: 3}


def test_state_and_step0_carry_a_jax_lattice():
    port, jax_sw = _pair(temp=2.1)
    jax_sw.advance(3)
    carried = cluster.SwendsenWang(
        SimConfig(nrows=16, ncols=32, seed=5, temp=2.1, device="cpu"),
        state=tuple(np.asarray(p) for p in jax_sw.bits()), step0=jax_sw.step)
    for sw in (carried, jax_sw):
        sw.advance(2)
    _assert_same(carried, jax_sw)


def _mag_lines(text):
    return [ln for ln in text.splitlines() if "magnetization" in ln]


@pytest.mark.parametrize("extra", [
    [], ["--field", "-0.3", "--xsl", "16", "--ysl", "8"],
    ["-t", "0.0", "-e"], ["-u", "0.3,2", "-E"], ["-m", "0.99", "-t", "1.0"],
    ["-w", "2", "--field", "0.2"],
])
def test_cli_prints_jax_magnetization_lines(extra, capsys):
    argv = ["--algo", "sw", "-x", "64", "-y", "32", "-n", "6", "-p", "2",
            "-a", "1.0", "-s", "41"] + extra
    assert jcli.main(argv) == 0
    want = _mag_lines(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("ising-tpu-torch run (Swendsen-Wang):")
    assert _mag_lines(out) == want and len(want) >= 2


def test_cli_sw_refusals(capsys):
    base = ["--algo", "sw", "-x", "64", "-y", "8", "--device", "cpu"]
    for extra in (["--resume", "x.ck"], ["--checkpoint", "x.ck"]):
        assert cli.main(base + extra) == 1
        err = capsys.readouterr().err
        assert jcli.main(base[:-2] + extra) == 1
        assert capsys.readouterr().err == err
        assert "does not support --resume/--checkpoint" in err
    assert cli.main(base + ["--backend", "packed"]) == 1
    err = capsys.readouterr().err
    assert "cluster updates operate on decoded planes; use backend='xla'" \
        in err
    assert cli.main(base + ["-J", "0.2"]) == 1
    assert "ferromagnetic" in capsys.readouterr().err


def test_fences_match_jax():
    for kw, msg in ((dict(backend="bit1", ncols=64), "decoded planes"),
                    (dict(j_prob=0.3), "ferromagnetic"),
                    (dict(nrows=1 << 16, ncols=1 << 15), "2\\^31")):
        args = {**dict(nrows=8, ncols=16, temp=2.0, backend="xla"), **kw}
        for make in (lambda: cluster.SwendsenWang(SimConfig(**args)),
                     lambda: jc.SwendsenWang(JaxConfig(**args))):
            with pytest.raises(ValueError, match=msg):
                make()
    sw = cluster.SwendsenWang(SimConfig(nrows=8, ncols=16, device="cpu"))
    with pytest.raises(ValueError, match="needs replica mode"):
        sw.replica_magnetizations()
    sw.advance(2)
    jsw = jc.SwendsenWang(JaxConfig(nrows=8, ncols=16, backend="xla"))
    jsw.advance(2)
    for got, want in zip(sw.fourier_partials(), jsw.fourier_partials()):
        assert isinstance(got, np.ndarray) and got.dtype == np.int64
        np.testing.assert_array_equal(got, want)


def test_jax_sw_fourier_partials_take_full_lattice_in_replica_mode():
    """The JAX SwendsenWang.fourier_partials (cluster.py:619-630) does not
    refuse replica mode, unlike its Simulation's: its line sums run over
    the full lattice, across the replicas. The port gives the same sums."""
    kw = dict(nrows=16, ncols=32, temp=2.0, backend="xla", xsl=16, ysl=8)
    jsw = jc.SwendsenWang(JaxConfig(**kw))
    sw = cluster.SwendsenWang(SimConfig(**kw, device="cpu"))
    jsw.advance(2)
    sw.advance(2)
    full = np.asarray(jax_compact_to_full(*jsw.bits()))
    want = (full.sum(axis=1), full.sum(axis=0))
    for got, jax_sums, line in zip(sw.fourier_partials(),
                                   jsw.fourier_partials(), want):
        np.testing.assert_array_equal(np.asarray(jax_sums), line)
        np.testing.assert_array_equal(got, line)


def test_sw_runs_on_cuda_by_default_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cluster.SwendsenWang(SimConfig(nrows=8, ncols=16))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py, or "
                    "pytest -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("Y,X,ysl,xsl", [(200, 328, None, None),
                                         (256, 256, 128, 128),
                                         (128, 256, 16, 16)])
def test_kernel_matches_plain_on_card(Y, X, ysl, xsl, cuda_device):
    """csrc/cluster_label.cu against its plain phases and labeler."""
    geo = dict(ysl=ysl, xsl=xsl)
    tile = cluster.pick_tile(Y, X, **geo)
    for p in (0.0, 0.585, 1.0):
        o_r, o_d = (_t(b).to(cuda_device) for b in _bonds(3, Y, X, p))
        want = cluster.tile_roots_reference(o_r, o_d, tile=tile, **geo)
        out = torch.empty((Y, X), dtype=torch.int32, device=cuda_device)
        cluster.tile_roots(o_r, o_d, out, tile=tile, **geo)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert torch.equal(cluster.label_clusters_tiled(o_r, o_d, **geo),
                           cluster.label_clusters(o_r, o_d, **geo))

"""The port's Swendsen-Wang over row slabs (cluster.label_slabs,
merge_slab_edges, sw_step_slabs, SwendsenWang with ndev > 1) against the
JAX package's sharded SW on the conftest's 8 virtual CPU devices, and
against one device.

Each slab is labelled alone, with its bonds to the next slab held back,
and the slabs are joined over those bonds; the labels must be the JAX
package's label_clusters of the whole lattice, and the trajectories its
sharded ones. Bonds and states are made with numpy from a seed. All
values are integers or bits: no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ising_tpu import SimConfig as JaxConfig
from ising_tpu import cli as jcli
from ising_tpu import cluster as jc
from ising_tpu.parallel.mesh import ROW_AXIS, make_mesh as jmake_mesh
from ising_tpu_torch import cli, cluster
from ising_tpu_torch.config import SimConfig
from ising_tpu_torch.parallel.mesh import split_rows

from test_cluster import uf_labels

CPU = torch.device("cpu")
TC = 2.269185


def _bonds(seed, Y, X, p):
    rs = np.random.RandomState(seed)
    return rs.rand(Y, X) < p, rs.rand(Y, X) < p


def _slabs(a, n):
    return split_rows(torch.from_numpy(np.ascontiguousarray(a)), [CPU] * n)


def _snake(Y, X):
    """One cluster through every row: each row open but for its wrap,
    joined to the next at alternate ends, so it crosses every slab edge."""
    o_r = np.ones((Y, X), bool)
    o_r[:, -1] = False
    o_d = np.zeros((Y, X), bool)
    o_d[0:Y - 1:2, -1] = True
    o_d[1:Y - 1:2, 0] = True
    return o_r, o_d


@pytest.mark.parametrize("Y,X,n", [(32, 32, 2), (32, 32, 8), (64, 96, 4),
                                   (16, 200, 8), (64, 128, 4)])
@pytest.mark.parametrize("p", [0.0, 0.585, 1.0])
def test_label_slabs_match_jax_labels_of_the_whole(Y, X, n, p):
    o_r, o_d = _bonds(Y * 7 + n, Y, X, p)
    want = np.asarray(jc.label_clusters(jnp.asarray(o_r), jnp.asarray(o_d)))
    r_slabs, d_slabs = _slabs(o_r, n), _slabs(o_d, n)
    kept = [d.clone() for d in d_slabs]
    labels, stats = cluster.label_slabs(r_slabs, d_slabs, return_stats=True)
    np.testing.assert_array_equal(torch.cat(labels).numpy(), want)
    per_slab = cluster.label_clusters_tiled(r_slabs[0], d_slabs[0],
                                            return_stats=True)[1]["launches"]
    assert stats == {"launches": n * per_slab}
    # the bond planes are left as given
    assert all(torch.equal(a, b) for a, b in zip(d_slabs, kept))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_snaking_cluster_crosses_every_slab_edge(n):
    Y, X = 32, 24
    o_r, o_d = _snake(Y, X)
    for cut in (False, True):
        if cut:
            o_d[Y // 2 - 1] = False     # a slab edge the halves meet at
        want = uf_labels(o_r, o_d)
        assert len(np.unique(want)) == 1 + cut
        got = cluster.label_slabs(_slabs(o_r, n), _slabs(o_d, n))
        np.testing.assert_array_equal(torch.cat(got).numpy(), want)


def test_a_cluster_around_the_ring():
    """A column cluster that closes through the periodic wrap (slab n-1
    to slab 0) takes the least id of its column."""
    Y, X, n = 16, 8, 4
    o_r = np.zeros((Y, X), bool)
    o_d = np.zeros((Y, X), bool)
    o_d[:, 3] = True
    got = torch.cat(cluster.label_slabs(_slabs(o_r, n),
                                        _slabs(o_d, n))).numpy()
    assert (got[:, 3] == 3).all()
    np.testing.assert_array_equal(got, uf_labels(o_r, o_d))


def test_merge_slab_edges_maps_only_what_the_edges_join():
    """Labels the edge bonds do not reach stay as they are; the joined
    ones take the least label of their merged component."""
    labels = [torch.tensor([[0, 1], [2, 3]], dtype=torch.int32),
              torch.tensor([[4, 5], [6, 7]], dtype=torch.int32)]
    edges = [torch.tensor([False, True]), torch.tensor([True, False])]
    got = cluster.merge_slab_edges(labels, edges)
    # slab 0's row 1 col 1 (3) joins slab 1's row 0 col 1 (5);
    # slab 1's row 1 col 0 (6) joins slab 0's row 0 col 0 (0).
    assert torch.equal(got[0], torch.tensor([[0, 1], [2, 3]],
                                            dtype=torch.int32))
    assert torch.equal(got[1], torch.tensor([[4, 3], [0, 7]],
                                            dtype=torch.int32))
    same = cluster.merge_slab_edges(labels, [torch.zeros(2, dtype=bool)] * 2)
    assert all(torch.equal(a, b) for a, b in zip(same, labels))


def test_labeler_sees_slabs_only(monkeypatch):
    """The labeler is never handed the whole lattice: one call a slab,
    each with a slab's planes."""
    calls = []
    real = cluster.label_clusters_tiled

    def spy(o_r, o_d, **kw):
        calls.append(tuple(o_r.shape))
        return real(o_r, o_d, **kw)

    monkeypatch.setattr(cluster, "label_clusters_tiled", spy)
    sw = cluster.SwendsenWang(SimConfig(nrows=32, ncols=64, temp=TC,
                                        ndev=4, device="cpu"))
    sw.advance(2)
    assert calls == [(8, 64)] * 8
    # 8 x 64 slabs are one tile each: one launch a slab
    assert sw.launch_counts == {4: 2}


def test_jax_tiled_labeler_over_a_mesh_matches_port_slabs():
    """The JAX package's Pallas labeler under its 8-device shard_map
    (interpret mode) and the port's slab labeling give the same labels."""
    from jax.sharding import NamedSharding, PartitionSpec
    Y, X = 64, 128
    o_r, o_d = _bonds(5, Y, X, 0.585)
    mesh = jmake_mesh(8)
    sh = NamedSharding(mesh, PartitionSpec(ROW_AXIS, None))
    want = np.asarray(jc.label_clusters_tiled(
        jax.device_put(jnp.asarray(o_r), sh),
        jax.device_put(jnp.asarray(o_d), sh), mesh=mesh))
    got = cluster.label_slabs(_slabs(o_r, 8), _slabs(o_d, 8))
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


@pytest.mark.parametrize("field", [0.0, 0.6, -0.3])
def test_sw_step_slabs_matches_sw_step(field):
    """One update over 4 slabs: sw_step's lattice and its draws of the
    ghost, slab by slab."""
    Y, X = 32, 48
    full = np.random.default_rng(3).integers(0, 2, (Y, X), dtype=np.uint8)
    thr = cluster.bond_threshold(TC)
    thr_g = cluster.bond_threshold(TC, abs(field))
    want = cluster.sw_step(torch.from_numpy(full), thr, 11, 5, field=field,
                           thr_ghost=thr_g)
    got = cluster.sw_step_slabs(_slabs(full, 4), thr, 11, 5, field=field,
                                thr_ghost=thr_g)
    assert torch.equal(torch.cat(got), want)


@pytest.mark.parametrize("ndev", [2, 4, 8])
@pytest.mark.parametrize("field", [0.0, 0.6])
def test_sw_runs_match_jax_and_one_device(ndev, field):
    base = dict(nrows=32, ncols=32, temp=TC, seed=7, backend="xla",
                field=field)
    state = tuple(np.random.default_rng(ndev).integers(
        0, 2, (32, 16), dtype=np.uint8) for _ in range(2))
    j = jc.SwendsenWang(JaxConfig(ndev=ndev, **base),
                        state=tuple(jnp.asarray(p) for p in state))
    one = cluster.SwendsenWang(SimConfig(device="cpu", **base), state=state)
    many = cluster.SwendsenWang(SimConfig(ndev=ndev, device="cpu", **base),
                                state=state)
    for s in (j, one, many):
        s.advance(3)
    assert isinstance(many.full, list) and len(many.full) == ndev
    for a, b, c in zip(j.bits(), one.bits(), many.bits()):
        np.testing.assert_array_equal(c.numpy(), np.asarray(a))
        assert torch.equal(b, c)
    assert many.measure() == one.measure()
    assert many.energy() == one.energy()
    for a, b in zip(many.fourier_partials(), j.fourier_partials()):
        np.testing.assert_array_equal(a, b)


def test_sw_default_init_per_slab_matches_jax():
    base = dict(nrows=64, ncols=64, temp=TC, seed=9, backend="xla")
    j = jc.SwendsenWang(JaxConfig(ndev=4, **base))
    p = cluster.SwendsenWang(SimConfig(ndev=4, device="cpu", **base))
    j.advance(2)
    p.advance(2)
    for a, b in zip(j.bits(), p.bits()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_sw_set_field_and_temperature_over_slabs():
    base = dict(nrows=32, ncols=32, temp=2.5, seed=4, backend="xla",
                field=0.2)
    sims = [cluster.SwendsenWang(SimConfig(ndev=n, device="cpu", **base))
            for n in (1, 4)]
    for s in sims:
        s.advance(2)
        s.set_field(-0.8)
        s.set_temperature(1.9)
        s.advance(2)
    assert sims[0].measure() == sims[1].measure()
    assert all(torch.equal(a, b) for a, b in zip(sims[0].bits(),
                                                 sims[1].bits()))


def test_replicas_over_slabs_refused_as_in_jax():
    kw = dict(nrows=32, ncols=32, backend="xla", xsl=16, ysl=8, ndev=2)
    with pytest.raises(ValueError) as want:
        jc.SwendsenWang(JaxConfig(**kw))
    with pytest.raises(ValueError) as got:
        cluster.SwendsenWang(SimConfig(device="cpu", **kw))
    assert str(got.value) == str(want.value)
    assert "replica cluster updates are single-device" in str(got.value)


def test_cli_sw_devs_lines_match_jax(capsys):
    argv = ["--algo", "sw", "-x", "64", "-y", "32", "-n", "4", "-p", "1",
            "-a", "1.0", "-s", "5", "--devs", "4"]
    assert jcli.main(argv) == 0
    jout = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    keep = lambda text: [ln for ln in text.splitlines()
                         if "magnetization" in ln or "devices" in ln]
    assert keep(out) == keep(jout) and len(keep(out)) == 7


@pytest.mark.gpu
def test_label_slabs_on_card_match_one_slab():
    """The three labeler kernels slab by slab on one card, joined, equal
    the whole lattice's labels (chip_smoke.py's [multi] phase does this
    at 4096^2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py, or "
                    "pytest -m gpu on the card)")
    dev = torch.device("cuda")
    o_r, o_d = (torch.from_numpy(b).to(dev)
                for b in _bonds(3, 512, 256, 0.585))
    want = cluster.label_clusters_tiled(o_r, o_d)
    got = cluster.label_slabs(split_rows(o_r, [dev] * 4),
                              split_rows(o_d, [dev] * 4))
    assert torch.equal(torch.cat(got), want)

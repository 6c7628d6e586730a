"""Guards of the port: no JAX in it, no quiet CPU path on the card, and a
chip_smoke.py that fails where there is no card."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from ising_tpu_torch import cluster
from ising_tpu_torch.models import ising
from ising_tpu_torch.ops import bit1, kernel_lib

ROOT = Path(__file__).resolve().parent.parent

BLOCK_JAX = textwrap.dedent("""
    import importlib.abc, pkgutil, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "ising_tpu"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import ising_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        ising_tpu_torch.__path__, "ising_tpu_torch.")
        if not m.name.endswith("__main__")]
    for name in names:
        __import__(name)
    import chip_smoke
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "ising_tpu")]
    assert not bad, bad
    print("imported", len(names), "modules")
""")


def _run(args, cwd, **kw):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH="")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=240, **kw)


def test_port_and_chip_smoke_import_without_jax():
    proc = _run([sys.executable, "-c", BLOCK_JAX], ROOT)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[1])
    assert n >= 15


def test_block_hook_refuses_jax():
    """The hook above really blocks: importing ising_tpu fails under it."""
    code = BLOCK_JAX.split("import ising_tpu_torch")[0] + "import ising_tpu\n"
    proc = _run([sys.executable, "-c", code], ROOT)
    assert proc.returncode != 0 and "blocked import" in proc.stderr


def _last_line(text):
    lines = [ln for ln in text.splitlines() if ln.strip()]
    return lines[-1] if lines else ""


def test_chip_smoke_fails_without_card():
    proc = _run([sys.executable, "chip_smoke.py"], ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in _last_line(proc.stdout)
    assert "FAILED" in proc.stdout


def test_chip_smoke_fails_outside_repository(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    proc = _run([sys.executable, "chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


class FakeCudaWords:
    """Stands in for a CUDA int32 tensor: what the wrapper checks."""

    def __init__(self, shape, ptr):
        self.shape, self.ptr = shape, ptr
        self.device = torch.device("cuda", 0)
        self.dtype = torch.int32

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.ptr

    def numel(self):
        return self.shape[0] * self.shape[1]

    def element_size(self):
        return 4


class FakeLib:
    def __init__(self, code=0):
        self.code, self.calls = code, []

    def bit1_sweep_launch(self, *args):
        self.calls.append(args)
        return self.code

    def bit1_planes_launch(self, *args):
        self.calls.append(("planes",) + args)
        return self.code

    def label_tile_roots_launch(self, *args):
        self.calls.append(("tile_roots",) + args)
        return self.code

    def label_hook_launch(self, *args):
        self.calls.append(("hook",) + args)
        return self.code

    def label_flatten_launch(self, *args):
        self.calls.append(("flatten",) + args)
        return self.code

    def ising_cuda_error_string(self, code):
        return b"fake error"


def _fake_args():
    H, W1 = 8, 4
    dst = FakeCudaWords((H, W1), 1 << 20)
    src = FakeCudaWords((H, W1), 2 << 20)
    up = FakeCudaWords((1, W1), (2 << 20) + 4 * W1 * (H - 1))
    dn = FakeCudaWords((1, W1), 2 << 20)
    return dst, src, up, dn


@pytest.fixture
def fake_card(monkeypatch):
    def plain_is_not_for_cuda(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")
    monkeypatch.setattr(bit1, "bit1_sweep_reference", plain_is_not_for_cuda)
    monkeypatch.setattr(bit1, "_cuda_stream", lambda device: 1234)
    lib = FakeLib()
    monkeypatch.setattr(kernel_lib, "load", lambda: (lib, None))
    return lib


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _per_thread_ops(family, rounds):
    """Operations of one generator call that take an input varying by
    thread, found by running the round structure on 'varies' flags: only
    the counter words vary; keys, step, tag and constants are per-launch."""
    ops = 0

    def op(*inputs):
        nonlocal ops
        v = any(inputs)
        ops += v
        return v

    if family == "philox":   # (c0, c1, c2, c3) = (q lo, q hi, step, tag)
        c = [True, True, False, False]
        for _ in range(rounds):
            m0, m1 = op(c[0]), op(c[2])        # two wide multiplies
            c = [op(m1, c[1]), m1, op(m0, c[3]), m0]   # two 3-input xors
        return ops
    x = [False] * 16                           # ChaCha: counter in x12, x13
    x[12] = x[13] = True

    def qr(a, b, c, d):
        for p, q, r in ((a, b, d), (c, d, b), (a, b, d), (c, d, b)):
            x[p] = op(x[p], x[q])              # add
            x[r] = op(x[r], x[p])              # xor
            x[r] = op(x[r])                    # rotate
    for _ in range(rounds // 2):
        for cols in ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14),
                     (3, 7, 11, 15), (0, 5, 10, 15), (1, 6, 11, 12),
                     (2, 7, 8, 13), (3, 4, 9, 14)):
            qr(*cols)
    return ops + sum(op(v) for v in x)         # feed-forward adds


@pytest.mark.parametrize("family,rounds", [("chacha", 4), ("chacha", 6),
                                           ("chacha", 8), ("philox", 7),
                                           ("philox", 10)])
def test_chip_smoke_bound_counts_only_per_thread_work(family, rounds):
    """chip_smoke.py's operation bound counts a generator call's work that
    varies by thread (plus the counter's 2), not its per-launch part."""
    draws, ops = _chip_smoke().call_ops(family, rounds)
    assert draws == {"chacha": 16, "philox": 4}[family]
    assert ops == _per_thread_ops(family, rounds) + 2


@pytest.mark.parametrize("mode,family,rounds", [
    ("philox", 0, 10), ("philox7", 0, 7), ("threefry", 1, 20),
    ("threefry13", 1, 13), ("chacha8", 2, 8), ("chacha6", 2, 6),
    ("chacha4", 2, 4)])
def test_wrapper_launches_kernel_on_cuda_tensor(fake_card, mode, family,
                                                rounds):
    dst, src, up, dn = _fake_args()
    thr = ising.threshold_table(0.0)
    before = bit1.bit1_sweep.launches
    out = bit1.bit1_sweep(dst, src, up, dn, thr, 6, 9, color=1, seed=5,
                          rng_mode=mode, greedy=True)
    assert out is dst
    assert bit1.bit1_sweep.launches == before + 1
    (args,) = fake_card.calls
    assert args[:4] == (dst.ptr, src.ptr, up.ptr, dn.ptr)
    assert args[4:10] == (8, 4, 6, 9, 1, 1)
    assert args[10:13] == tuple(int(t) for t in thr[7:10])
    assert args[15:18] == (family, rounds, 1)
    assert args[18:] == (0, 0, 0, 0, bit1.LINKS_NONE, 0, 0, 1234)


@pytest.mark.parametrize("mode,family,rounds,kbits,tag", [
    ("philox7b", 0, 7, 16, 1), ("threefry13b", 1, 13, 16, 1),
    ("chacha8b", 2, 8, 16, 1), ("chacha6b", 2, 6, 16, 1),
    ("chacha4b", 2, 4, 16, 1), ("hw", 0, 10, 24, 0x8001)])
@pytest.mark.parametrize("temp,field,accept", [(1.5, 0.0, 0), (0.0, 0.0, 1),
                                               (1.5, 0.3, 2)])
def test_wrapper_launches_planes_kernel(fake_card, mode, family, rounds,
                                        kbits, tag, temp, field, accept):
    dst, src, up, dn = _fake_args()
    acc = bit1.plane_accept_args(mode, temp, field)
    before = bit1.bit1_sweep.launches
    bit1.bit1_sweep(dst, src, up, dn, ising.threshold_table(temp, field), 6,
                    9, color=1, seed=5, rng_mode=mode, greedy=temp <= 0,
                    **acc)
    assert bit1.bit1_sweep.launches == before + 1
    (args,) = fake_card.calls
    assert args[0] == "planes"
    assert args[1:5] == (dst.ptr, src.ptr, up.ptr, dn.ptr)
    assert args[5:11] == (8, 4, 6, 9, tag, 1)
    if family == 1:
        from ising_tpu_torch.rng import threefry_stream_key
        assert args[11:13] == threefry_stream_key(5, 9, tag)
    else:
        assert args[11:13] == (5, 0)
    assert args[13:17] == (family, rounds, kbits, accept)
    table = list(args[17])
    assert len(table) == kernel_lib.TABLE_WORDS
    # AcceptTable: TABLE_KBITS bit-words of t4k and of t8k, the draw-class
    # bits, 10 always-words, then TABLE_KBITS bit-words per class
    K = kernel_lib.TABLE_KBITS

    def bit_words(t):
        return [0xFFFFFFFF * (t >> z & 1) for z in range(K)]

    if field:
        tvals10, always10 = acc["tvals10"], acc["always10"]
        draws = [c for c in range(10)
                 if not always10 >> c & 1 and tvals10[c]]
        assert table[:2 * K] == [0] * (2 * K)
        assert table[2 * K] == sum(1 << c for c in draws)
        assert table[2 * K + 1:2 * K + 11] == [0xFFFFFFFF * (always10 >> c & 1)
                                               for c in range(10)]
        bits = table[2 * K + 11:]
        for c in range(10):
            want = tvals10[c] if c in draws else 0
            assert bits[c * K:(c + 1) * K] == bit_words(want)
    else:
        assert table[:K] == bit_words(acc["t4k"])
        assert table[K:2 * K] == bit_words(acc["t8k"])
        assert table[2 * K:] == [0] * (kernel_lib.TABLE_WORDS - 2 * K)
        assert max(acc["t4k"], acc["t8k"]) < 1 << kbits
    assert args[18:] == (0, 0, 0, 0, bit1.LINKS_NONE, 0, 0, 1234)


def test_wrapper_raises_on_failed_launch(fake_card):
    fake_card.code = 700
    dst, src, up, dn = _fake_args()
    before = bit1.bit1_sweep.launches
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        bit1.bit1_sweep(dst, src, up, dn, ising.threshold_table(1.0), 0, 0,
                        color=0, seed=1, rng_mode="philox", greedy=False)
    assert bit1.bit1_sweep.launches == before


def test_wrapper_raises_when_kernel_cannot_build(monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(bit1, "bit1_sweep_reference",
                        lambda *a, **k: pytest.fail("fell back to plain"))
    monkeypatch.setattr(bit1, "_cuda_stream", lambda device: 0)
    monkeypatch.setattr(kernel_lib, "load", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        bit1.bit1_sweep(*_fake_args(), ising.threshold_table(1.0), 0, 0,
                        color=0, seed=1, rng_mode="threefry13", greedy=False)


def test_wrapper_refuses_in_place_aliasing(fake_card):
    dst, src, up, dn = _fake_args()
    with pytest.raises(ValueError, match="overlap"):
        bit1.bit1_sweep(dst, dst, up, dn, ising.threshold_table(1.0), 0, 0,
                        color=0, seed=1, rng_mode="philox", greedy=False)
    assert fake_card.calls == []


def test_kernel_sources_have_no_torch_headers():
    for src in (ROOT / "ising_tpu_torch" / "csrc").glob("*.cu*"):
        text = src.read_text()
        includes = [ln for ln in text.splitlines() if ln.startswith("#include")]
        assert includes and not any("torch" in ln or "ATen" in ln or "c10" in ln
                                    for ln in includes)
        if src.suffix == ".cu":   # compiled sources; .cuh headers are shared
            assert 'extern "C"' in text
    assert "-gencode" in kernel_lib.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kernel_lib.NVCC_FLAGS


def test_gitignore_lists_build_and_dump_outputs():
    text = (ROOT / ".gitignore").read_text().split()
    for entry in ("ising_tpu_torch/_build/", "final_*.txt"):
        assert entry in text


def test_pack_reference_dtypes_roundtrip():
    words = np.array([[0, 1, 0x80000000, 0xFFFFFFFF]], np.uint32)
    t = torch.from_numpy(words.view(np.int32).copy())
    assert bit1.pack_bits1(bit1.unpack_bits1(t)).numpy().view(np.uint32) \
        .tolist() == words.tolist()


FAKE_NVCC = """#!/bin/sh
# Stands in for nvcc: writes the file named after -o, reports ptxas lines.
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  case "$1" in *broken*) echo "error: broken source"; exit 2;; esac
  shift
done
echo "ptxas info    : Used 40 registers" >&2
echo "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" >&2
echo built > "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    monkeypatch.setattr(kernel_lib, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernel_lib, "CSRC_DIR", csrc)
    monkeypatch.setattr(kernel_lib, "BUILD_DIR", tmp_path / "_build")
    return csrc


def test_build_compiles_each_source_and_reuses_by_hash(fake_nvcc):
    info = kernel_lib.build()
    assert not info.cached and info.seconds > 0
    assert Path(info.path).read_text() == "built\n"
    assert len([ln for ln in info.ptxas if "registers" in ln]) == 2
    assert sorted(p.name for p in Path(info.path).parent.iterdir()) == [
        "libising_kernels.so", "libising_kernels.so.sha256", "ptxas.txt"]
    again = kernel_lib.build()
    assert again.cached and again.ptxas == info.ptxas
    (fake_nvcc / "a.cu").write_text("// a, changed\n")
    assert not kernel_lib.build().cached


def test_build_failure_raises(fake_nvcc):
    (fake_nvcc / "broken.cu").write_text("// broken\n")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernel_lib.build()


def _fake_links(H=8, W1=4):
    return [FakeCudaWords((H, W1), (4 + z) << 20) for z in range(4)]


@pytest.mark.parametrize("kw,mode,csl,ysl", [
    (dict(), bit1.LINKS_JPLANES, 0, 0),
    (dict(split_links=True), bit1.LINKS_SPLIT, 0, 0),
    (dict(csl=2, ysl=8), bit1.LINKS_JPLANES, 2, 8),
])
@pytest.mark.parametrize("rng_mode", ["threefry13", "chacha6b"])
def test_wrapper_passes_geometry(fake_card, kw, mode, csl, ysl, rng_mode):
    """The link planes, link mode, csl and ysl reach either launcher, just
    before the stream."""
    dst, src, up, dn = _fake_args()
    links = _fake_links()
    bit1.bit1_sweep(dst, src, up, dn, ising.threshold_table(1.5), 0, 1,
                    links, color=0, seed=5, rng_mode=rng_mode, greedy=False,
                    **bit1.plane_accept_args(rng_mode, 1.5), **kw)
    (args,) = fake_card.calls
    assert args[-8:] == (*(p.ptr for p in links), mode, csl, ysl, 1234)


def test_wrapper_refuses_bad_geometry(fake_card):
    dst, src, up, dn = _fake_args()
    thr = ising.threshold_table(1.5)
    kw = dict(color=0, seed=5, rng_mode="philox", greedy=False)
    for extra, args, msg in (
            (dict(csl=3), (), "csl"), (dict(ysl=3), (), "ysl"),
            (dict(split_links=True), (), "link store"),
            (dict(split_links=True, csl=2), (_fake_links(),), "replicas"),
            (dict(), (_fake_links()[:3],), "4 word planes"),
            (dict(), ([FakeCudaWords((4, 4), 9 << 20)] * 4,), "shape")):
        with pytest.raises(ValueError, match=msg):
            bit1.bit1_sweep(dst, src, up, dn, thr, 0, 1, *args, **kw, **extra)
    # dst must not alias a J plane (the kernel updates dst in place)
    links = _fake_links()
    links[2] = FakeCudaWords((8, 4), dst.ptr + 4)
    with pytest.raises(ValueError, match="J plane"):
        bit1.bit1_sweep(dst, src, up, dn, thr, 0, 1, links, **kw)
    assert fake_card.calls == []


class FakeCudaPlane(FakeCudaWords):
    """A CUDA tensor of another dtype, for the labeler's checks."""

    def __init__(self, shape, ptr, dtype):
        super().__init__(shape, ptr)
        self.dtype = dtype

    def numel(self):
        return int(np.prod(self.shape))

    def element_size(self):
        return 1 if self.dtype == torch.bool else 4


def _fake_bonds(Y=8, X=16):
    return (FakeCudaPlane((Y, X), 1 << 20, torch.bool),
            FakeCudaPlane((Y, X), 2 << 20, torch.bool))


@pytest.fixture
def fake_label_card(monkeypatch, fake_card):
    """The fake card, with torch.empty handing out fake CUDA planes (at
    3 << 20, 4 << 20, ...) and every plain phase refusing to run."""
    def plain_is_not_for_cuda(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")
    for name in ("local_pass_reference", "tile_roots_reference",
                 "hook_reference", "flatten_reference", "label_clusters"):
        monkeypatch.setattr(cluster, name, plain_is_not_for_cuda)
    monkeypatch.setattr(cluster, "_cuda_stream", lambda device: 1234)
    planes = []

    def empty(shape, dtype=None, device=None):
        assert torch.device(device).type == "cuda"
        planes.append(FakeCudaPlane(tuple(shape), (3 + len(planes)) << 20,
                                    dtype))
        return planes[-1]
    monkeypatch.setattr(torch, "empty", empty)
    fake_card.planes = planes
    return fake_card


def _launches():
    return tuple(f.launches for f in cluster.LABEL_PHASES)


@pytest.mark.parametrize("geo,tile,labels_ptr", [
    (dict(), (4, 8), 3 << 20),                      # in place on the lattice
    (dict(ysl=8, xsl=8), (4, 8), 4 << 20)])          # replicas: a new plane
def test_label_pass_launches_kernel_on_cuda_tensor(fake_label_card, geo,
                                                   tile, labels_ptr):
    """A labeling on CUDA tensors: tile_roots, hook_roots, flatten_roots,
    in that order, with their pointers and geometry, each counted once,
    with no plain phase and no host read."""
    o_r, o_d = _fake_bonds()
    before = _launches()
    labels, stats = cluster.label_clusters_tiled(o_r, o_d, tile=tile,
                                                 return_stats=True, **geo)
    ysl, xsl = geo.get("ysl", 8), geo.get("xsl", 16)
    parent = 3 << 20
    assert fake_label_card.calls == [
        ("tile_roots", o_r.ptr, o_d.ptr, parent, 8, 16, ysl, xsl, *tile, 0,
         1234),
        ("hook", o_r.ptr, o_d.ptr, parent, 8, 16, ysl, xsl, *tile, 1234),
        ("flatten", parent, labels_ptr, 8, 16, ysl, xsl, *tile, 1234)]
    assert labels.ptr == labels_ptr and stats == {"launches": 3}
    assert _launches() == tuple(n + 1 for n in before)


def test_label_pass_launches_once_with_whole_replica_tiles(fake_label_card):
    """Tiles that hold whole replicas: one tile_roots launch writing ids."""
    o_r, o_d = _fake_bonds()
    before = _launches()
    labels, stats = cluster.label_clusters_tiled(o_r, o_d, ysl=4, xsl=8,
                                                 tile=(4, 16),
                                                 return_stats=True)
    assert fake_label_card.calls == [
        ("tile_roots", o_r.ptr, o_d.ptr, 3 << 20, 8, 16, 4, 8, 4, 16, 1,
         1234)]
    assert labels.ptr == 3 << 20 and stats == {"launches": 1}
    assert _launches() == (before[0] + 1, *before[1:])


@pytest.mark.parametrize("failing", ["tile_roots", "hook", "flatten"])
def test_label_pass_raises_on_failed_launch(fake_label_card, failing,
                                            monkeypatch):
    """A launch that fails raises, the later phases do not launch, and the
    failed phase's counter does not move."""
    lib = fake_label_card
    name = f"label_{failing}_launch"

    def fail(*args):
        lib.calls.append((failing,) + args)
        return 700
    monkeypatch.setattr(lib, name, fail)
    before = _launches()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        cluster.label_clusters_tiled(*_fake_bonds(), tile=(4, 8))
    k = ("tile_roots", "hook", "flatten").index(failing)
    assert [c[0] for c in lib.calls] == ["tile_roots", "hook",
                                         "flatten"][:k + 1]
    assert _launches() == tuple(n + (i < k) for i, n in enumerate(before))


def test_label_pass_raises_when_kernel_cannot_build(monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    for name in ("tile_roots_reference", "hook_reference",
                 "flatten_reference"):
        monkeypatch.setattr(cluster, name,
                            lambda *a, **k: pytest.fail("fell back to plain"))
    monkeypatch.setattr(cluster, "_cuda_stream", lambda device: 0)
    monkeypatch.setattr(kernel_lib, "load", no_nvcc)
    o_r, o_d = _fake_bonds()
    out = FakeCudaPlane((8, 16), 3 << 20, torch.int32)
    for call in (lambda: cluster.tile_roots(o_r, o_d, out, tile=(8, 16)),
                 lambda: cluster.hook_roots(o_r, o_d, out, tile=(8, 16)),
                 lambda: cluster.flatten_roots(out, out, tile=(8, 16))):
        with pytest.raises(RuntimeError, match="nvcc"):
            call()


def test_label_pass_refuses_aliasing_and_bad_tiles(fake_label_card):
    o_r, o_d = _fake_bonds()
    parent = FakeCudaPlane((8, 16), 3 << 20, torch.int32)
    inside = FakeCudaPlane((8, 16), (1 << 20) + 64, torch.int32)
    labels = FakeCudaPlane((8, 16), (3 << 20) + 8, torch.int32)
    for call, msg in (
            (lambda: cluster.tile_roots(o_r, o_d, inside, tile=(8, 16)),
             "overlap"),
            (lambda: cluster.hook_roots(o_r, o_d, inside, tile=(8, 16)),
             "overlap"),
            (lambda: cluster.flatten_roots(parent, labels, tile=(8, 16)),
             "overlap"),
            (lambda: cluster.flatten_roots(parent, parent, tile=(8, 16),
                                           ysl=4), "overlap"),
            (lambda: cluster.flatten_roots(parent, parent, tile=(8, 17)),
             "tile"),
            (lambda: cluster.tile_roots(o_r, o_d, parent, tile=(16, 16)),
             "tile"),
            (lambda: cluster.hook_roots(o_r, o_d, parent, tile=(8, 16),
                                        xsl=3), "replicas")):
        with pytest.raises(ValueError, match=msg):
            call()
    assert fake_label_card.calls == []

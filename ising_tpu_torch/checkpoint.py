"""Checkpoint and resume (torch), in the JAX package's v2 file format.

The port of ``ising_tpu/checkpoint.py``, writing and reading the same
bytes, so that either package resumes the other's checkpoint. With a
counter rng mode every draw is a function of (seed, site, step, color),
so a resumed run continues the trajectory bit for bit.

Format (version 2, streamed):

    magic "ISINGCK2" | u32 header_len (little-endian) | header JSON | body

The header holds the version, the geometry, the chunk height, the step,
the temperature and the run's config as the JAX package's SimConfig JSON
(its 24 fields, in its order: the port's `device` never goes to disk; the
reader names the device). The body is row chunks in order, each the black
plane's rows then the white plane's, bit-packed along the row in
np.packbits order (first column in the top bit). Saving and loading go one
chunk at a time, and the packing and unpacking run on the state's device,
so only the packed bytes cross to the host.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .config import SimConfig, resolve_device

MAGIC = b"ISINGCK2"
FORMAT_VERSION = 2


def _chunk_schedule(nrows: int, chunk_rows: int):
    c = max(2, min(chunk_rows, nrows) & ~1)  # even-height chunks (parity)
    return [(r, min(nrows, r + c)) for r in range(0, nrows, c)], c


def _pack_rows(bits):
    """(n, ch) {0,1} plane -> (n, ceil(ch/8)) uint8 numpy bytes in
    np.packbits order. A tensor is packed on its device and only the bytes
    are copied to the host."""
    if isinstance(bits, np.ndarray):
        return np.packbits(bits, axis=1)
    n, ch = bits.shape
    pad = (-ch) % 8
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    g = bits.reshape(n, (ch + pad) // 8, 8).to(torch.uint8)
    out = torch.zeros(g.shape[:2], dtype=torch.uint8, device=bits.device)
    for z in range(8):
        out |= g[:, :, z] << (7 - z)
    return out.cpu().numpy()


def _unpack_rows_device(packed, ch: int, device):
    """(n, nb) packed bytes (numpy or a tensor) -> (n, ch) uint8 plane on
    `device`, unpacked there (the bytes are copied, not the plane)."""
    d = torch.as_tensor(packed).to(device)
    cols = [(d >> (7 - z)) & 1 for z in range(8)]
    return torch.stack(cols, dim=2).reshape(d.shape[0], 8 * d.shape[1])[:, :ch]


def save_checkpoint_streamed(path: str, decode_rows, nrows: int, ncols: int,
                             *, step: int, temp: float, cfg: SimConfig,
                             chunk_rows: int = 8192,
                             packed_rows=None) -> None:
    """Write a checkpoint one row chunk at a time.

    decode_rows(r0, r1) -> compact (black, white) uint8 planes of rows
    [r0, r1). packed_rows(r0, r1), when given, replaces it: it returns the
    chunk's bytes already packed (bit1 shuffles them out of its words), the
    same file bytes without a decode.
    """
    ch = ncols // 2
    row_bytes = (ch + 7) // 8
    schedule, c = _chunk_schedule(nrows, chunk_rows)
    header = json.dumps({
        "version": FORMAT_VERSION,
        "nrows": nrows,
        "ncols": ncols,
        "chunk_rows": c,
        "step": int(step),
        "temp": float(temp),
        "config": cfg.to_json(),
    }).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(np.uint32(len(header)).astype("<u4").tobytes())
        f.write(header)
        for r0, r1 in schedule:
            if packed_rows is not None:
                fn, what, want = "packed_rows", "bytes", (r1 - r0, row_bytes)
                chunk = packed_rows(r0, r1)
            else:
                fn, what, want = "decode_rows", "plane", (r1 - r0, ch)
                chunk = decode_rows(r0, r1)
            for name, p in zip(("black", "white"), chunk):
                if tuple(p.shape) != want:
                    raise ValueError(
                        f"{fn}({r0},{r1}) returned {name} {what} of shape "
                        f"{tuple(p.shape)}, expected {want}")
            for p in chunk:
                if packed_rows is None:
                    p = _pack_rows(p)
                elif torch.is_tensor(p):
                    p = p.cpu().numpy()
                f.write(np.asarray(p, np.uint8).tobytes())


def save_checkpoint(path: str, black, white, *, step: int, temp: float,
                    cfg: SimConfig) -> None:
    """save_checkpoint_streamed of in-memory compact uint8 planes."""
    save_checkpoint_streamed(
        path, lambda r0, r1: (black[r0:r1], white[r0:r1]),
        black.shape[0], 2 * black.shape[1], step=step, temp=temp, cfg=cfg)


def read_checkpoint_meta(path: str, device="cuda") -> dict:
    """The header: {'nrows', 'ncols', 'chunk_rows', 'step', 'temp', 'cfg',
    '_body_offset'}, with 'cfg' the run's SimConfig on `device`."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            if magic[:4] == b"PK\x03\x04":
                raise ValueError(
                    f"{path!r} is a v1 (.npz) checkpoint; the v1 format is "
                    "no longer supported — re-save it from a 0.2.x tree "
                    "or regenerate the run")
            raise ValueError(
                f"{path!r} is not an ising-tpu v{FORMAT_VERSION} checkpoint "
                f"(bad magic {magic!r})")
        (hlen,) = np.frombuffer(f.read(4), "<u4")
        meta = json.loads(f.read(int(hlen)).decode())
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta['version']}")
    meta["cfg"] = SimConfig.from_json(meta.pop("config"), device=str(device))
    if (meta["nrows"], meta["ncols"]) != (meta["cfg"].nrows,
                                          meta["cfg"].ncols):
        raise ValueError(
            f"checkpoint {path!r} is inconsistent: stored planes are "
            f"{meta['nrows']}x{meta['ncols']} but the embedded config says "
            f"{meta['cfg'].nrows}x{meta['cfg'].ncols} (edited file?)")
    meta["_body_offset"] = len(MAGIC) + 4 + int(hlen)
    return meta


def load_checkpoint_state(path: str, encode=None, encode_packed=None,
                          device="cuda"):
    """Read the body back one chunk at a time; returns ((black, white),
    meta), on `device`.

    encode (a backend's bit planes -> storage) turns each chunk into
    storage as it is read, so only the storage accumulates; without it the
    result is the compact uint8 planes. encode_packed(pb, pw) takes the
    file's packed bytes instead (bit1: straight to words) and takes
    precedence; where it returns None, encode is used.
    """
    dev = resolve_device(device)
    meta = read_checkpoint_meta(path, device=str(device))
    nrows, ncols, c = meta["nrows"], meta["ncols"], meta["chunk_rows"]
    ch = ncols // 2
    row_bytes = (ch + 7) // 8
    schedule, _ = _chunk_schedule(nrows, c)
    header_len = meta["_body_offset"]
    expect = header_len + 2 * nrows * row_bytes
    actual = os.path.getsize(path)
    if actual != expect:
        raise ValueError(
            f"checkpoint {path!r} is inconsistent: file is {actual} bytes "
            f"but the header implies {expect} (truncated or edited file?)")
    bs, ws = [], []
    with open(path, "rb") as f:
        f.seek(header_len)
        for r0, r1 in schedule:
            n = r1 - r0
            pb, pw = (np.frombuffer(bytearray(f.read(n * row_bytes)),
                                    np.uint8).reshape(n, row_bytes)
                      for _ in range(2))
            pair = None if encode_packed is None else encode_packed(pb, pw)
            if pair is None:
                pair = (_unpack_rows_device(pb, ch, dev),
                        _unpack_rows_device(pw, ch, dev))
                if encode is not None:
                    pair = encode(*pair)
            bs.append(pair[0])
            ws.append(pair[1])
    return (torch.cat(bs), torch.cat(ws)), meta


def load_checkpoint(path: str, device="cuda"):
    """(black, white, step, temp, cfg): compact uint8 planes on `device`.
    A resume at scale should stream into a backend's storage instead
    (load_checkpoint_state with its encode)."""
    (black, white), meta = load_checkpoint_state(path, device=device)
    return black, white, meta["step"], meta["temp"], meta["cfg"]

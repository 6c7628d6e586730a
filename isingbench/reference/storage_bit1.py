"""How the bit1 backend stores a lattice, read plainly.

The reference reads the program's words only to judge them: this turns
them back into spins, with nothing of the program.
"""

from __future__ import annotations

import torch


def decode(black, white, rows):
    """(len(rows), X) uint8 spins of 1-bit words: (n, W) int32 planes of
    each color, bit g of word j the site at compact column g * W + j; on an
    even row black holds the even columns, on an odd row the odd ones."""
    n, W = black.shape
    g = torch.arange(32, device=black.device, dtype=torch.int32)

    def compact(words):
        bits = (words[:, None, :] >> g[None, :, None]) & 1
        return bits.reshape(n, 32 * W).to(torch.uint8)

    b, w = compact(black), compact(white)
    odd = (rows % 2 == 1)[:, None].to(black.device)
    full = torch.empty((n, 64 * W), dtype=torch.uint8, device=black.device)
    full[:, 0::2] = torch.where(odd, w, b)
    full[:, 1::2] = torch.where(odd, b, w)
    return full

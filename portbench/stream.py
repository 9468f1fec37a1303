"""The general traffic generator: device-resident periodic streams made from the seed.

A traffic mix (``portbench/traffic/<mix>.json``) gives the stream's length
per row, ``stream_samples``; a configuration gives its rows and planes.  The
stream is made on the device from ``--seed`` in one call per plane, and is
periodic: sample ``i`` of a row is ``base[i % S]``.  The buffer holds ``S +
extra`` samples a row, the last ``extra`` a copy of the first, so that a
chunk that crosses the end of the stream is still one view.

Also here: the windowed-sinc lowpass that both configurations design their
taps with, and the seeded sample of the chunks whose outputs are checked.
"""

from __future__ import annotations

import math
import random
from typing import List, Tuple

import numpy as np
import torch

def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number
    below 2**64)."""

    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))


def periodic_planes(planes: int, rows: int, samples: int, extra: int, seed: int,
                    device) -> List[torch.Tensor]:
    """``planes`` float32 buffers [rows, samples + extra] of standard normal
    samples, each periodic with period ``samples``."""

    if extra > samples:
        raise ValueError(f"extra {extra} > stream samples {samples}")
    gen = generator(seed, device)
    out = []
    for _ in range(planes):
        buf = torch.empty((rows, samples + extra), dtype=torch.float32, device=device)
        buf[:, :samples].normal_(generator=gen)
        buf[:, samples:].copy_(buf[:, :extra])
        out.append(buf)
    return out


def lowpass(num_taps: int, cutoff: float) -> np.ndarray:
    """Hamming-windowed sinc lowpass (cutoff in cycles per sample), float64,
    unit gain at DC."""

    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * n) * np.hamming(num_taps)
    return h / h.sum()


class Reservoir:
    """A uniform sample of ``k`` chunks out of however many the window
    completes (Li's algorithm L), its draws made from the seed.  It holds
    a chunk's output only while the chunk is in the sample."""

    def __init__(self, k: int, seed: int):
        if k < 1:
            raise ValueError(f"a sample of {k} chunks checks nothing")
        self.k = int(k)
        self.rng = random.Random(int(seed))
        self.slots: List[Tuple[int, object]] = []
        self.seen = 0
        self.w = math.exp(math.log(self._u()) / self.k)
        self.next = self.k + int(math.log(self._u()) / math.log(1 - self.w))

    def _u(self) -> float:
        """A uniform draw in (0, 1)."""

        while True:
            u = self.rng.random()
            if u > 0.0:
                return u

    def offer(self, index: int, item) -> None:
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.slots.append((index, item))
        elif i == self.next:
            self.slots[self.rng.randrange(self.k)] = (index, item)
            self.w *= math.exp(math.log(self._u()) / self.k)
            self.next += 1 + int(math.log(self._u()) / math.log(1 - self.w))

    def items(self) -> List[Tuple[int, object]]:
        """The kept chunks by chunk index."""

        return sorted(self.slots, key=lambda kv: kv[0])

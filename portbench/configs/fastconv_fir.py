"""Driver of ``fastconv_fir``: pffastconv's overlap-save FIR through the port's public entry.

16 real float32 channels stream through ``FastConv(h).apply_batched(x,
flush=False)``.  Each call hands the rows from the read position, the
unconsumed tail of the last chunk first, up to the next 2^22 new samples: a
view of the device-resident stream, with no copy made here.  The call's
output length is what it consumed; the read position moves on by it.

The work a chunk must do, whatever implements it: each input sample read
once (the carried tail is the state, read once), each output written once,
the taps read once; the overlap-save operations, two real blocks to a
complex transform: 5 nfft log2 nfft each way and 6 nfft for the product.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from .. import stream
from ..reference import fastconv_fir as reference
from ..reference import rel_err


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from pffft_tpu_torch import conv

        self.rows = int(config["channels"])
        self.chunk = int(traffic["chunk_samples"])
        self.taps = stream.lowpass(int(traffic["filter_len"]), float(config["cutoff"]))
        self.nfft = reference.block_len(len(self.taps))
        self.period = int(traffic["stream_samples"])
        if self.period < self.chunk + self.nfft:
            raise ValueError(f"stream of {self.period} samples is shorter than a chunk "
                             f"({self.chunk}) and a block ({self.nfft})")
        (self.buf,) = stream.periodic_planes(1, self.rows, self.period, self.chunk + self.nfft,
                                             seed, device)
        self.entry = conv.FastConv(self.taps, block_len=int(config["block_len"]), device=device)
        self.pos, self.end = 0, self.chunk
        self.log: List[Tuple[int, int]] = []  # (length handed, length returned) a chunk

    def feed(self) -> tuple:
        return (self.buf[:, self.pos:self.end],)

    def call(self, x):
        return self.entry.apply_batched(x, flush=False)

    def advance(self, y) -> int:
        n = int(y.shape[-1])
        self.log.append((self.end - self.pos, n))
        self.pos += n
        self.end += self.chunk
        if self.pos >= self.period:
            self.pos -= self.period
            self.end -= self.period
        return self.rows * n

    def keep(self, y):
        return y

    def work(self, first: int, last: int) -> Tuple[float, float]:
        """(bytes, operations) of chunks first .. last - 1."""

        u = self.nfft - len(self.taps) + 1
        per_col = 10.0 * self.nfft * math.log2(self.nfft) + 6.0 * self.nfft
        nbytes = flops = 0.0
        for length, n in self.log[first:last]:
            nbytes += 4.0 * (self.rows * (length + n) + len(self.taps))
            flops += self.rows * (n / u) / 2.0 * per_col
        return nbytes, flops

    def use_control(self) -> None:
        self.call = lambda x: reference.control(x, self.taps)

    def release(self) -> None:
        self.entry = None

    def check(self, kept, limits: dict):
        """([(name, value, limit)], chunks judged wrong): every chunk's
        length handed and returned against pffastconv's, and the kept
        chunks' outputs against the float64 reference."""

        sched = reference.schedule(len(self.log), self.chunk, len(self.taps))
        bad = {c for c, ((length, n), (_, want_len, want)) in enumerate(zip(self.log, sched))
               if (length, n) != (want_len, want)}
        base = self.buf[:, :self.period]
        errs = {c: rel_err(y, reference.expected(base, self.taps, sched[c][0], sched[c][2]))
                for c, y in kept}
        wrong = bad | {c for c, e in errs.items() if e > limits["rel_err"]}
        return [("rel_err", max(errs.values(), default=0.0), limits["rel_err"]),
                ("bad_chunks", len(bad), limits["bad_chunks"])], len(wrong)

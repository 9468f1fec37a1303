"""Driver of ``pfb_channelizer``: the polyphase channelizer through the port's public entry.

4 complex float32 streams, held as two device-resident planes [4, S], step
through ``Channelizer.from_weights(w).process_split(state, x_re, x_im)``:
chunk c is the view of samples c*L .. c*L + L - 1 of each plane (L = K*M,
the stream wrapping at S, a multiple of L), and the state that a step
returns goes into the next.

The work a chunk must do, whatever implements it: both planes of the chunk
read once and the channels [4, K, M] written once, the carried history
(P*M samples a stream, both planes) read and written once, the weights read
once; P multiply-adds a sample and plane, and 5 M log2 M for each frame's
transform.
"""

from __future__ import annotations

import math
from typing import Tuple

from .. import stream
from ..reference import pfb_channelizer as reference
from ..reference import rel_err


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from pffft_tpu_torch import channelizer

        self.m = int(config["num_channels"])
        self.p = int(config["taps_per_channel"])
        self.rows = int(config["streams"])
        self.frames = int(traffic["frames_per_chunk"])
        self.length = self.frames * self.m
        self.period = int(traffic["stream_samples"])
        if self.period % self.length:
            raise ValueError(f"stream of {self.period} samples is no multiple of a chunk "
                             f"({self.length})")
        self.weights = stream.lowpass(self.p * self.m, 0.5 / self.m).reshape(self.p, self.m)
        self.re, self.im = stream.periodic_planes(2, self.rows, self.period, 0, seed, device)
        self.entry = channelizer.Channelizer.from_weights(self.weights, device=device)
        self.state = self.entry.init_state((self.rows,), device)
        self.shape = (self.rows, self.frames, self.m)
        self.log = []  # True where a chunk's channels came out [R, K, M] in both planes

    def feed(self) -> tuple:
        a = len(self.log) * self.length % self.period
        return self.state, self.re[:, a:a + self.length], self.im[:, a:a + self.length]

    def call(self, state, x_re, x_im):
        return self.entry.process_split(state, x_re, x_im)

    def advance(self, out) -> int:
        (yr, yi), self.state = out
        self.log.append(tuple(yr.shape) == self.shape and tuple(yi.shape) == self.shape)
        return self.rows * self.length

    def keep(self, out):
        return out[0]

    def work(self, first: int, last: int) -> Tuple[float, float]:
        """(bytes, operations) of chunks first .. last - 1."""

        chunks = len(self.log[first:last])
        samples = self.rows * self.length
        nbytes = 4.0 * (2 * samples + 2 * samples + 2 * 2 * self.rows * self.p * self.m
                        + self.p * self.m)
        flops = 2.0 * 2 * self.p * samples + 5.0 * self.m * math.log2(self.m) * self.rows * self.frames
        return chunks * nbytes, chunks * flops

    def use_control(self) -> None:
        self.call = lambda state, xr, xi: reference.control(state, xr, xi, self.weights)

    def release(self) -> None:
        self.entry = self.state = None

    def check(self, kept, limits: dict):
        """([(name, value, limit)], chunks judged wrong): every chunk's
        channel shape, and the kept chunks' channels against the complex128
        reference, which works each chunk's history out again."""

        bad = {c for c, ok in enumerate(self.log) if not ok}
        base_re, base_im = (t[:, :self.period] for t in (self.re, self.im))
        errs = {}
        for c, (yr, yi) in kept:
            ref = reference.expected(base_re, base_im, self.weights, self.frames, c)
            errs[c] = max(rel_err(yr, ref.real), rel_err(yi, ref.imag))
        wrong = bad | {c for c, e in errs.items() if e > limits["rel_err"]}
        return [("rel_err", max(errs.values(), default=0.0), limits["rel_err"]),
                ("bad_chunks", len(bad), limits["bad_chunks"])], len(wrong)

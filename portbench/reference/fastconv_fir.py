"""Plain reference of ``fastconv_fir``: pffastconv's streamed valid-mode FIR.

pffastconv's contract (``pffastconv.c``: ``pffastconv_new_setup``,
``pffastconv_apply`` without flush), for a real filter h of F taps:

* the block length is nfft = max(2 * next_pow2(F - 1), 32), and each block
  yields u = nfft - F + 1 outputs;
* a call on L samples consumes nb * u of them, nb = ceil((L - nfft + 1) / u)
  blocks (none where L < nfft), and returns as many outputs,
  y[i] = sum_j x[i + j] * h[F - 1 - j];
* the caller carries the L - consumed samples it did not consume into the
  next call, before the next chunk's new samples.

The stream is periodic: sample i of a row is ``base[:, i % S]``.  Chunk c
hands the samples from the read position up to (c + 1) * chunk.  All of it
is worked out here again from the stream and the taps, in float64 (exact
products, FFT convolution of the whole chunk).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import tf32

ROW_BLOCK = 4  # rows convolved at once, to bound the reference's memory


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def block_len(filter_len: int) -> int:
    """pffastconv's nfft for a filter of ``filter_len`` taps (block length 0)."""

    return max(2 * next_pow2(filter_len - 1), 32)


def consumed(length: int, filter_len: int) -> int:
    """Samples that one call on ``length`` samples consumes (and outputs)."""

    nfft = block_len(filter_len)
    u = nfft - filter_len + 1
    max_off = length - nfft + 1
    return 0 if max_off <= 0 else -(-max_off // u) * u


def schedule(chunks: int, chunk: int, filter_len: int) -> List[Tuple[int, int, int]]:
    """(start, length, consumed) of chunks 0 .. chunks - 1 of the stream,
    start counted from the stream's first sample (not wrapped)."""

    out, pos, end = [], 0, chunk
    for _ in range(chunks):
        n = consumed(end - pos, filter_len)
        out.append((pos, end - pos, n))
        pos += n
        end += chunk
    return out


def stream_slice(base: torch.Tensor, start: int, length: int) -> torch.Tensor:
    """Samples start .. start + length - 1 of the periodic stream, [R, length]."""

    s = base.shape[-1]
    idx = (torch.arange(length, device=base.device, dtype=torch.int64) + start) % s
    return base[:, idx]


def valid(x: torch.Tensor, h: np.ndarray, n: int) -> torch.Tensor:
    """y[r, i] = sum_j x[r, i + j] h[F - 1 - j] for i < n, float64 [R, n]."""

    f = len(h)
    size = next_pow2(n + 2 * f - 2)
    hf = torch.fft.rfft(torch.from_numpy(np.asarray(h, np.float64)).to(x.device), size)
    out = []
    for r0 in range(0, x.shape[0], ROW_BLOCK):
        xs = x[r0:r0 + ROW_BLOCK, :n + f - 1].to(torch.float64)
        full = torch.fft.irfft(torch.fft.rfft(xs, size) * hf, size)
        out.append(full[:, f - 1:f - 1 + n])
    return torch.cat(out)


def expected(base: torch.Tensor, h: np.ndarray, start: int, n: int) -> torch.Tensor:
    """The outputs of a chunk whose read position is ``start``: [R, n] float64."""

    return valid(stream_slice(base, start, n + len(h) - 1), h, n)


def control(x: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """The control: one call computed by this reference from operands
    rounded to TF32 (the stream's samples and the taps), as a TF32 path
    would multiply them; float32 [R, consumed]."""

    h32 = tf32(torch.from_numpy(np.asarray(h, np.float32))).double().cpu().numpy()
    n = consumed(x.shape[-1], len(h))
    return valid(tf32(x), h32, n).to(torch.float32)

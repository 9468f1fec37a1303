"""Host-side stream framing for the overlap-save pipelines.

The port's copy of the Python form of ``pffft_tpu.runtime.StreamFramer``
(the numpy ring buffer).  The reference's C++ ring buffer
(``runtime/native/stream_buffer.cc``) is not ported yet (ROADMAP.md A7), so
``native`` is always False here.
"""

from __future__ import annotations

import numpy as np

__all__ = ["StreamFramer"]


class StreamFramer:
    """Overlap-save stream framer.

    push() arbitrary float chunks; frames() returns [k, frame_len] batches
    advancing by ``hop`` with ``frame_len - hop`` samples of carried
    overlap (the block-cutting loop of pffastconv_apply), so the device
    sees fixed shapes.
    """

    def __init__(self, frame_len: int, hop: int):
        if hop < 1 or hop > frame_len:
            raise ValueError("need 1 <= hop <= frame_len")
        self.frame_len = int(frame_len)
        self.hop = int(hop)
        self._buf = np.zeros(0, dtype=np.float32)

    @property
    def native(self) -> bool:
        return False

    def push(self, x) -> int:
        x = np.ascontiguousarray(np.asarray(x, dtype=np.float32).ravel())
        self._buf = np.concatenate([self._buf, x])
        return x.size

    def pending(self) -> int:
        return int(self._buf.size)

    def frames(self, max_frames: int = 1 << 16) -> np.ndarray:
        """Pop all complete frames: [k, frame_len] float32 (k may be 0)."""

        k = 0
        frames = []
        while self._buf.size >= self.frame_len and k < max_frames:
            frames.append(self._buf[: self.frame_len].copy())
            self._buf = self._buf[self.hop :]
            k += 1
        return np.stack(frames) if frames else np.empty((0, self.frame_len), np.float32)

    def flush(self) -> np.ndarray:
        """Drain remaining samples as one zero-padded frame ([1, frame_len]
        with the pending samples) or an empty array."""

        if self._buf.size == 0:
            return np.empty((0, self.frame_len), np.float32)
        out = np.zeros((1, self.frame_len), dtype=np.float32)
        n = min(self._buf.size, self.frame_len)
        out[0, :n] = self._buf[:n]
        self._buf = self._buf[n:]
        return out

"""Object API: the pffft.hpp ``Fft<T>`` analog.

Counterpart of ``pffft_tpu/wrapper.py``: a type-parameterized transform
object with ``prepareLength``-style replanning, ordered forward/inverse,
internal-layout transforms, spectrum reorder and frequency-domain
convolution, over torch tensors.

  * no work buffers: the vector factory methods return zeroed tensors of
    the right shape and dtype on the object's device;
  * every method accepts leading batch axes;
  * numpy input goes to ``device`` (default "cuda"); tensors stay on their
    device.

Type mapping (pffft.hpp Types<T>):
  float32    -> REAL transform, fp32 engine
  float64    -> REAL transform, fp64 engine (pffftd_ parity)
  complex64  -> COMPLEX transform, fp32
  complex128 -> COMPLEX transform, fp64
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import fft as _fft
from . import plan as _plan

__all__ = ["Fft"]

_KIND_BY_DTYPE = {
    np.dtype(np.float32): (_plan.REAL, "float32"),
    np.dtype(np.float64): (_plan.REAL, "float64"),
    np.dtype(np.complex64): (_plan.COMPLEX, "float32"),
    np.dtype(np.complex128): (_plan.COMPLEX, "float64"),
}

_TORCH_DTYPES = {np.dtype(v): k for k, v in _fft._NP_DTYPES.items()}


class Fft:
    """pffft::Fft<T> analog.

    >>> f = Fft(np.float32, 1024)
    >>> spec = f.forward(x)                      # [..., 512] complex packed
    >>> y = f.inverse(spec) / f.length           # == x
    """

    def __init__(self, dtype=np.float32, length: Optional[int] = None, *,
                 device: Optional[str] = None):
        dt = np.dtype(dtype)
        if dt not in _KIND_BY_DTYPE:
            raise TypeError(
                f"unsupported Fft dtype {dt}; use float32/float64/complex64/complex128"
            )
        self._kind, self._scalar = _KIND_BY_DTYPE[dt]
        self._dtype = dt
        self.device = device
        self._plan: Optional[_plan.Plan] = None
        if length is not None:
            self.prepare_length(length)

    # --- plan management ----------------------------------------------
    def prepare_length(self, n: int) -> "Fft":
        """prepareLength parity: (re)plan for transform size n."""

        self._plan = _plan.Plan.create(n, self._kind, self._scalar)
        return self

    prepareLength = prepare_length  # C++ spelling

    @property
    def plan(self) -> _plan.Plan:
        if self._plan is None:
            raise RuntimeError("call prepare_length(n) first")
        return self._plan

    @property
    def length(self) -> int:
        """getLength parity."""

        return self.plan.n

    @property
    def spectrum_size(self) -> int:
        """getSpectrumSize parity: complex bins in the (packed) spectrum."""

        return self.plan.spectrum_size

    @property
    def internal_layout_size(self) -> int:
        """getInternalLayoutSize parity: scalar floats in the internal
        z-domain representation (2 per complex bin)."""

        return 2 * self.plan.spectrum_size

    @property
    def is_complex_transform(self) -> bool:
        return self.plan.kind == _plan.COMPLEX

    # --- static helpers -------------------------------------------------
    @staticmethod
    def is_valid_size(n: int, dtype=np.float32) -> bool:
        kind, _ = _KIND_BY_DTYPE[np.dtype(dtype)]
        return _plan.is_valid_size(n, kind)

    @staticmethod
    def nearest_transform_size(n: int, dtype=np.float32, higher: bool = True) -> int:
        kind, _ = _KIND_BY_DTYPE[np.dtype(dtype)]
        return _plan.nearest_transform_size(n, kind, higher)

    @staticmethod
    def simd_size() -> int:
        return _plan.simd_size()

    # --- ordered transforms ----------------------------------------------
    def forward(self, x):
        """Ordered forward transform (canonical spectrum)."""

        return _fft.transform_ordered(self.plan, x, _plan.FORWARD, device=self.device)

    def inverse(self, spectrum):
        """Ordered unscaled inverse: inverse(forward(x)) == N * x."""

        return _fft.transform_ordered(self.plan, spectrum, _plan.BACKWARD, device=self.device)

    # --- internal-layout transforms --------------------------------------
    def forward_to_internal_layout(self, x):
        return _fft.transform(self.plan, x, _plan.FORWARD, device=self.device)

    def inverse_from_internal_layout(self, z):
        return _fft.transform(self.plan, z, _plan.BACKWARD, device=self.device)

    forwardToInternalLayout = forward_to_internal_layout
    inverseFromInternalLayout = inverse_from_internal_layout

    def reorder_spectrum(self, z, direction=_plan.FORWARD):
        """reorderSpectrum parity: internal <-> canonical."""

        return _fft.zreorder(self.plan, z, direction, device=self.device)

    reorderSpectrum = reorder_spectrum

    # --- frequency-domain convolution --------------------------------------
    def convolve(self, a, b, scaling=1.0):
        """convolve parity: pointwise multiply of internal-layout spectra."""

        return _fft.zconvolve_no_accu(self.plan, a, b, scaling, device=self.device)

    def convolve_accumulate(self, a, b, ab, scaling=1.0):
        return _fft.zconvolve_accumulate(self.plan, a, b, ab, scaling, device=self.device)

    convolveAccumulate = convolve_accumulate

    # --- vector factories (valueVector / spectrumVector) -------------------
    def _zeros(self, shape, dtype: torch.dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device or "cuda")

    def value_vector(self, *batch: int) -> torch.Tensor:
        """Zeroed time-domain tensor [*batch, N]."""

        return self._zeros((*batch, self.length), _TORCH_DTYPES[self._dtype])

    def spectrum_vector(self, *batch: int) -> torch.Tensor:
        """Zeroed canonical-spectrum tensor [*batch, spectrum_size] complex."""

        return self._zeros((*batch, self.spectrum_size), _TORCH_DTYPES[self.plan.cdtype])

    def internal_layout_vector(self, *batch: int) -> torch.Tensor:
        """Zeroed internal-layout tensor (complex bins, z-domain order)."""

        return self._zeros((*batch, self.spectrum_size), _TORCH_DTYPES[self.plan.cdtype])

    valueVector = value_vector
    spectrumVector = spectrum_vector
    internalLayoutVector = internal_layout_vector

    def __repr__(self) -> str:  # pragma: no cover
        n = self._plan.n if self._plan else None
        return f"Fft(dtype={self._dtype.name}, length={n})"

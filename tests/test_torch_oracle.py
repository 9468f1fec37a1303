"""The port's FFTPACK oracle (``pffft_tpu_torch.oracle``) against the JAX
package's (``pffft_tpu.oracle``): the same numpy float64 code, so every
function must agree bit for bit (``np.array_equal``, NaN equal to NaN), or
raise the same exception, on the same seeded inputs."""

import warnings

import numpy as np
import pytest

from pffft_tpu import oracle as ref_oracle
from pffft_tpu_torch import oracle as port_oracle

NS = (1, 2, 3, 5, 7, 12, 16, 60, 1024, 1009)
COMPLEX_IN = {"cfftf", "cfftb"}


def test_same_public_names():
    assert port_oracle.__all__ == ref_oracle.__all__


def _outcome(fn, x):
    with warnings.catch_warnings(), np.errstate(all="ignore"):
        warnings.simplefilter("ignore")
        try:
            return fn(x)
        except Exception as e:  # the error itself is the outcome compared
            return type(e)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", ref_oracle.__all__)
def test_bit_for_bit(name, n):
    rng = np.random.default_rng(1000 * n + len(name))
    inputs = [rng.standard_normal((2, n)), rng.standard_normal(n)]
    if name in COMPLEX_IN:
        inputs.append(rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n)))
    for x in inputs:
        want = _outcome(getattr(ref_oracle, name), x.copy())
        got = _outcome(getattr(port_oracle, name), x.copy())
        if isinstance(want, type):
            assert got is want, (name, n, got, want)
            continue
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (name, n)
        np.testing.assert_array_equal(got, want)

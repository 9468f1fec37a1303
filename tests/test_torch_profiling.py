"""The port's profiling utilities (``pffft_tpu_torch.utils``) against the
JAX package's (``pffft_tpu.utils``): the same Roofline arithmetic, the
reference's device_info keys where they have a meaning, and a trace that
is written and stopped whatever its body does."""

import glob
import os

import pytest
import torch

from pffft_tpu.utils import profiling as ref_prof
from pffft_tpu_torch import utils as port_utils
from pffft_tpu_torch.utils import profiling as port_prof

ROOFLINES = (
    dict(bytes_moved=16 * 4096 * 4096, flops=5.0 * 4096 * 12 * 4096, seconds=1.2e-4,
         peak_bw=3.35e12),
    dict(bytes_moved=1000, flops=123.0, seconds=0.5),
    dict(bytes_moved=1 << 30, flops=0.0, seconds=3.0, peak_bw=1e9),
)


def test_same_public_names():
    assert port_utils.__all__ == ["trace", "device_info", "Roofline"]
    assert set(port_prof.__all__) == set(ref_prof.__all__)


@pytest.mark.parametrize("kw", ROOFLINES)
def test_roofline_equals_reference(kw):
    got, want = port_prof.Roofline(**kw), ref_prof.Roofline(**kw)
    for prop in ("effective_bw", "gflops", "sol_seconds", "sol_fraction"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.as_dict() == want.as_dict()


def test_device_info_cpu_keys():
    info = port_prof.device_info(device="cpu")
    ref_keys = {"platform", "device_kind", "num_devices", "process_count", "coords",
                "python", "host", "hbm_bytes_limit", "hbm_bytes_in_use"}
    assert set(info) == ref_keys | {"torch_version", "cuda_version"}
    assert info["platform"] == "cpu" and info["num_devices"] == 1
    assert info["process_count"] == 1 and info["coords"] is None
    assert info["hbm_bytes_limit"] is None and info["hbm_bytes_in_use"] is None
    assert info["torch_version"] == torch.__version__
    assert info["cuda_version"] == torch.version.cuda


def test_device_info_defaults_to_the_card():
    if torch.cuda.is_available():
        info = port_prof.device_info()
        assert info["platform"] == "gpu" and info["hbm_bytes_limit"] > 0
        assert info["device_kind"] == torch.cuda.get_device_name(0)
    else:  # no card: an error, never the CPU's metadata under the card's name
        with pytest.raises((RuntimeError, AssertionError)):
            port_prof.device_info()


def _traces(d):
    return glob.glob(os.path.join(str(d), "**", "*.pt.trace.json"), recursive=True)


def test_trace_writes_a_file(tmp_path):
    with port_prof.trace(str(tmp_path / "tb")) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert len(_traces(tmp_path)) == 1
    assert any("mm" in e.key for e in prof.key_averages())


def test_trace_stops_when_the_body_raises(tmp_path):
    with pytest.raises(KeyError):
        with port_prof.trace(str(tmp_path / "tb")):
            torch.randn(8) + 1
            raise KeyError("body")
    assert not torch.autograd.profiler._is_profiler_enabled
    assert len(_traces(tmp_path)) == 1
    with port_prof.trace(str(tmp_path / "again")):  # a new trace starts cleanly
        torch.randn(8) * 2
    assert len(_traces(tmp_path / "again")) == 1

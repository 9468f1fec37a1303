"""Each cell's bytes and operations a chunk against hand-worked values, and the
seeded sample of checked chunks."""

import json
import math
import subprocess
import sys

import pytest
import torch

import tiny
from portbench import run, stream


def cell(workload: str):
    return run.make_cell(tiny.BENCH, workload, 3, "cpu", tiny.traffic(workload))[0]


def test_fir_taps1024_by_hand():
    c = cell("fir_taps1024")
    # a first chunk: 2^22 samples handed, 4091 blocks of u = 1025 out, 16 rows
    c.log = [(4194304, 4193275)]
    nbytes, flops = c.work(0, 1)
    assert nbytes == 4 * (16 * (4194304 + 4193275) + 1024) == 536_809_152
    # two real blocks a complex nfft-2048 transform: 10 * 2048 * 11 + 6 * 2048 a column
    assert flops == 16 * 4091 / 2 * 237_568 == 7_775_125_504
    # at 3.35 TB/s and 67 TFLOP/s the bytes bind: 0.1602 ms against 0.1160 ms
    assert nbytes / 3.35e12 > flops / 67e12


def test_fir_taps4096_by_hand():
    c = cell("fir_taps4096")
    c.log = [(4194304, 1022 * 4097)] * 2
    nbytes, flops = c.work(0, 2)
    assert nbytes == 2 * 4 * (16 * (4194304 + 4187134) + 4096)
    assert flops == 2 * 16 * 1022 / 2 * (10 * 8192 * 13 + 6 * 8192)
    assert math.isclose(flops / 2 / 67e12 * 1e3, 0.1359, rel_tol=1e-3)  # "about 0.14 ms"
    assert nbytes / 2 / 3.35e12 > flops / 2 / 67e12


@pytest.mark.parametrize("frames,nbytes,flops", [
    # 4 streams x K frames x 4096 channels; both planes in and out, the
    # 8 x 4096 history of both planes read and written, the weights once
    (1024, 270_663_680, 1_543_503_872),  # chan_bulk
    (8, 4_325_376, 12_058_624),  # the low-latency mix, portbench/traffic/lowlat.json
])
def test_channelizer_by_hand(frames, nbytes, flops):
    c = cell("chan_bulk")
    c.frames, c.length, c.log = frames, frames * 4096, [True, True, True]
    assert c.work(1, 3) == (2 * nbytes, 2 * flops)


def test_reservoir_is_seeded_and_uniform():
    picks = []
    for seed in range(400):
        r = stream.Reservoir(4, seed)
        for i in range(100):
            r.offer(i, i)
        kept = [i for i, _ in r.items()]
        assert len(kept) == 4 and kept == sorted(set(kept))
        picks += kept
    runs = [stream.Reservoir(4, 7) for _ in range(2)]
    for r in runs:
        for i in range(100):
            r.offer(i, i)
    assert runs[0].items() == runs[1].items()
    # uniform: each tenth of the stream gets about a tenth of the picks
    counts = [sum(1 for p in picks if lo <= p < lo + 10) for lo in range(0, 100, 10)]
    assert min(counts) > 0.6 * len(picks) / 10 and max(counts) < 1.4 * len(picks) / 10


def test_seeded_stream_repeats_and_wraps():
    a = stream.periodic_planes(2, 3, 64, 16, 2**40 + 5, "cpu")
    b = stream.periodic_planes(2, 3, 64, 16, 2**40 + 5, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(a[0][:, 64:], a[0][:, :16])
    assert not torch.equal(a[0], stream.periodic_planes(2, 3, 64, 16, 6, "cpu")[0])


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "chan_bulk",
                           "--seed", str(2**33 + 1), "--seconds", "2", "--trace", "1"],
                          cwd=tiny.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["metrics"]["dispatch.launches_per_chunk"]["value"] == 3.0

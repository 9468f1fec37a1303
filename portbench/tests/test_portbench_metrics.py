"""The per-run readers of ``portbench/metrics/``: what each reads from a run's record,
and that a reader with nothing sound to read gives nothing; and what the trace's
reader counts as unsound."""

import time
from types import SimpleNamespace

import pytest

from portbench import run, trace


def read(name: str, **record):
    return run.load("metrics", name).read(SimpleNamespace(**record))


def test_idle_pct_is_the_device_only_sub_windows_own_share():
    trace = {"busy_s": 0.28, "window_s": 0.4, "chunks": 400}
    assert read("device.idle_pct", trace=trace) == pytest.approx(30.0)


@pytest.mark.parametrize("busy_s, window_s", [(0.41, 0.4), (0.1, 0.0)])
def test_idle_pct_gives_nothing_where_the_readings_disagree(busy_s, window_s):
    trace = {"busy_s": busy_s, "window_s": window_s, "chunks": 400}
    assert read("device.idle_pct", trace=trace) is None


def test_idle_pct_gives_nothing_untraced():
    assert read("device.idle_pct", trace=None) is None


def test_chunk_p95_is_the_tail_of_every_chunk():
    chunk_ms = [1.0] * 960 + [5.0] * 40
    assert read("chunk_ms_p95", chunk_ms=chunk_ms) == pytest.approx(1.0)
    assert read("chunk_ms_p95", chunk_ms=chunk_ms + [5.0] * 20) == pytest.approx(5.0)
    assert read("chunk_ms_p95", chunk_ms=[1.0] * 199) is None


class _SlowSync:
    """A cell whose synchronise takes 20 ms after an entry that returns at once."""

    def feed(self):
        return ()

    def call(self):
        return None

    def advance(self, out):
        return 1


def test_a_chunks_time_runs_to_the_synchronises_return():
    loop = run.Loop(_SlowSync(), "cpu")
    loop.sync = lambda: time.sleep(0.02)
    _, samples, ms, enqueue_s = loop.step()
    assert samples == 1
    assert ms >= 20.0
    assert enqueue_s < 0.02


def kineto(kernel_ts: float, launch_ts: float = 10.0, sync_end: float = 60.0) -> dict:
    """A Chrome trace of one launch, its kernel of 20 µs and the synchronise
    after it, in a window of 100 µs."""

    return {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0.0, "dur": 100.0,
         "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch_ts,
         "dur": 5.0, "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 16.0,
         "dur": sync_end - 16.0, "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "void conv_stream_kernel<16>(float const*)",
         "ts": kernel_ts, "dur": 20.0, "args": {"correlation": 7}},
    ]}


@pytest.mark.parametrize("kernel_ts, sync_end, misplaced", [
    (15.0, 60.0, 0.0),  # launched at 10, ended at 35, the synchronise returned at 60
    (8.0, 60.0, 2.0),  # begins 2 µs before its launch
    (-3990.0, 60.0, 4000.0),  # placed 4 ms early: before the window, launched inside it
    (50.0, 60.0, 10.0),  # ends 10 µs after the synchronise that waited for it returned
])
def test_the_reader_counts_by_launch_and_measures_misplacement(kernel_ts, sync_end, misplaced):
    found = trace.read(kineto(kernel_ts, sync_end=sync_end), {"conv_stream_kernel"})
    assert found["hand_kernels"] == 1 and found["misplaced_us"] == misplaced
    # the device alone holds no launch to hold it against, and counts what it holds
    alone = trace.read(kineto(kernel_ts, sync_end=sync_end), {"conv_stream_kernel"}, host=False)
    assert alone["misplaced_us"] == 0.0 and alone["hand_kernels"] == 1


def test_a_kernel_launched_outside_the_window_is_not_counted():
    found = trace.read(kineto(115.0, launch_ts=110.0, sync_end=160.0), {"conv_stream_kernel"})
    assert found["hand_kernels"] == 0

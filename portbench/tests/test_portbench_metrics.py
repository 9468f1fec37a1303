"""The per-run readers of ``portbench/metrics/``: what each reads from a run's record,
and that a reader with nothing sound to read gives nothing."""

import time
from types import SimpleNamespace

import pytest

from portbench import run


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

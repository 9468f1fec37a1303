"""Launches of the port's hand kernels a chunk, by the wrappers' own counters
(``<wrapper>.launches``) over the profiled chunks, which the profiler's count
matched."""


def read(run):
    tr = run.trace
    return tr["counter_launches"] / tr["chunks"] if tr and tr["chunks"] else None

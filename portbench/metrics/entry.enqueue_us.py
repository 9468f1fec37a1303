"""Host time of the entry call up to its return, with no synchronise: the median
over the traced run's window chunks."""

import statistics


def read(run):
    return statistics.median(run.enqueue_s) * 1e6 if run.enqueue_s else None

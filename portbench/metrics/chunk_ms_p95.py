"""The 95th percentile of the window's chunk times, on the host's clock: from just
before the chunk is handed to the entry to the return of the
``torch.cuda.synchronize()`` after the entry returns."""

import statistics


def read(run):
    if len(run.chunk_ms) < 200:  # fewer than ten chunks would lie beyond it
        return None
    return statistics.quantiles(run.chunk_ms, n=100, method="inclusive")[94]

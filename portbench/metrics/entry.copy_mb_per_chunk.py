"""Bytes written by the layout copies of the port's entries outside its hand
kernels, in MB an entry call: the program's own counters
(``pffft_tpu_torch.utils.profiling.counters``), ``entry.copy_bytes`` over the
sum of ``entry.calls.*``, over every call of the run.  Nothing where the
program keeps no such counters or no entry was called."""

import sys


def read(run):
    counters = getattr(sys.modules.get("pffft_tpu_torch.utils.profiling"), "counters", None)
    if counters is None:
        return None
    calls = sum(v for k, v in counters.items() if k.startswith("entry.calls."))
    if not calls:
        return None
    return counters.get("entry.copy_bytes", 0) / calls / 1e6

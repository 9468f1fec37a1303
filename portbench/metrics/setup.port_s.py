"""The port's own share of ``setup_s``, in seconds: the sum of the program's
``setup.seconds.*`` counters (``pffft_tpu_torch.utils.profiling.counters``),
its import, library loads (a checkout's first run builds them), plans and
filter spectra, each part's time without the parts nested in it.  Nothing
where the program keeps no such counters."""

import sys


def read(run):
    counters = getattr(sys.modules.get("pffft_tpu_torch.utils.profiling"), "counters", None)
    parts = [v for k, v in (counters or {}).items() if k.startswith("setup.seconds.")]
    return sum(parts) if parts else None

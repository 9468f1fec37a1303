"""The device's idle time a chunk that the trace puts down to the port's own host
code, in microseconds: the idle gaps of the host-profiled sub-window whose
innermost host range is one of the port's spans (``pffft.entry``,
``pffft.dispatch``, ``pffft.launch``, ``pffft.layout``), summed, over its
chunks.  Gaps named by a torch op or by the harness are left out; so are the
port's gaps beyond the trace's ten largest names, each smaller than the tenth.
Nothing where the run was not traced or the program opens no such spans
(``pffft_tpu_torch.utils.profiling.span``)."""

import sys

PREFIX = "pffft."


def read(run):
    tr = run.trace
    prof = sys.modules.get("pffft_tpu_torch.utils.profiling")
    if not tr or not tr.get("chunks") or "idle_gaps" not in tr or not hasattr(prof, "span"):
        return None
    idle_s = sum(s for name, s in tr["idle_gaps"] if name.startswith(PREFIX))
    return idle_s / tr["chunks"] * 1e6

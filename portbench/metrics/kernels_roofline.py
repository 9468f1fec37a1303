"""The chunk's least time on the card over its device-busy time, in percent.

The least time is the larger of the chunk's bytes over the peak memory rate
and its operations over the peak float32 rate (``portbench/peaks.json``);
the bytes and operations are the configuration's own count of the work
(``Cell.work``), the busy time the union of the device's ops in the profiled
sub-window, a chunk's share.  Nothing where the card has no peaks listed."""


def read(run):
    tr, peak = run.trace, run.peaks.get(run.device_kind)
    if not tr or not peak or tr["busy_s"] <= 0 or run.bytes_per_chunk is None:
        return None
    least = max(run.bytes_per_chunk / peak["bytes_per_s"],
                run.flops_per_chunk / peak["flops_per_s"])
    return 100.0 * least / (tr["busy_s"] / tr["chunks"])

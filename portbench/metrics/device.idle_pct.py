"""The share of the profiled sub-window that records the device alone in which no
device op ran, in percent: 1 - ``busy_s`` / ``window_s`` of the run's ``device``
block, the union of the device's ops over the sub-window's length on the host's
clock.  The profiler's launch records lengthen that sub-window where the host
sets the pace, so this reads at or above the untraced window's idle share.
Nothing where the busy time exceeds the window: the two readings disagree."""


def read(run):
    tr = run.trace
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] > tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

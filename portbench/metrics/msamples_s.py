"""Input samples of every chunk completed in the window, over the window (host clock)."""


def read(run):
    return run.samples / run.window_s / 1e6

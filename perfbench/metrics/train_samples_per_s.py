"""Training samples of the window's steps over the window's seconds, the
device synchronised at the window's end (host clock)."""


def read(run):
    return run.samples / run.window_s

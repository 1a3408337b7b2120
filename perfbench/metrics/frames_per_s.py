"""Frames completed in the window over the window's seconds (host clock)."""


def read(run):
    return run.units / run.window_s

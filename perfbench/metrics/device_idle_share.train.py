"""100 x (1 - device busy seconds / wall seconds) over the traced run's
first slice, which the profiler records for the device alone (busy: the
union of kernels, copies and sets; one stream, so they do not overlap).
No host operations are recorded there, so the host runs near its
unprofiled pace."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.wall_s)

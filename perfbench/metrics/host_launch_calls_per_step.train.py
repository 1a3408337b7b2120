"""CUDA launch calls the host made per step of the traced slice, from
the profiler's CUDA API events (``cudaLaunchKernel``, ``cuLaunchKernel`` and
their kin; a graph launch counts one)."""


def read(run):
    if run.trace is None or run.trace.launch_calls == 0:
        return None
    return run.trace.launch_calls / run.trace.units

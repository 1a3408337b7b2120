"""Device milliseconds a frame: the union of the device's operations
(kernels, copies, sets) over the slice of ``device_frames`` frames that
follows the window, recorded by the profiler for the device alone, over
its frames. The time the card is held for a frame, whatever the host's
pace."""


def read(run):
    d = run.device_slice
    if d is None or d.busy_s <= 0:
        return None
    return 1e3 * d.busy_s / d.units

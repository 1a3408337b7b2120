"""Median, over the window's frames, of the host ms in the program's
``atdn::slam.pose_wait`` span: the host blocked on the pose's copy, the
device work not hidden behind dispatch (frames chosen as
``host_step_ms.stream``)."""

from perfbench.core.spec import reader

_read = reader("host_step_ms.stream")


def read(run):
    return _read(run, names=("atdn::slam.pose_wait",))

"""Median, over the window's frames that registered a keyframe (an
``atdn::keyframes.append`` inside the frame's ``atdn::slam.keyframe``
span), of the host ms in ``atdn::slam.keyframe``: the decision, the
frame's copy to the host and the hand-off to the writer thread (frames
chosen as ``host_step_ms.stream``)."""

from perfbench.core.spec import reader

_read = reader("host_step_ms.stream")


def read(run):
    return _read(run, names=("atdn::slam.keyframe",), keyframes_only=True)

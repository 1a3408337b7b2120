"""Median, over the window's frames, of the host ms in the program's
``atdn::slam.flow`` and ``atdn::slam.odometry`` spans of each frame:
issuing the flow net and ATDNVO, with any wait on the device hidden
inside it.

The spans are the program's (``atdn_vslam_torch.utils.profiling``),
read from its in-memory ring after the run; the window runs unprofiled.
The window's frames are the ``atdn::slam.frame`` roots of the newest
runtime (its call index starts at 0) whose ids lie in ``[warm_frames,
warm_frames + units)``: the stream hands frame i to the runtime as its
call i. None where the program records no spans, or where the ring no
longer holds every frame of the window.

``read(run, names, keyframes_only)`` sums other children of the frame
(``pose_wait_ms``), or takes only the frames that registered a keyframe
(``keyframe_ms``).
"""

import statistics
from collections import defaultdict

FRAME = "atdn::slam.frame"


def read(run, names=("atdn::slam.flow", "atdn::slam.odometry"), keyframes_only=False):
    try:
        from atdn_vslam_torch.utils.profiling import spans
    except ImportError:
        return None
    records = spans()
    roots = [s for s in records if s.name == FRAME and s.parent is None]
    newest = 0
    for k in range(1, len(roots)):
        if roots[k].request <= roots[k - 1].request:
            newest = k
    first = run.cell.traffic["warm_frames"]
    window = [s for s in roots[newest:] if first <= s.request < first + run.units]
    if sorted(s.request for s in window) != list(range(first, first + run.units)):
        return None
    kids = defaultdict(list)
    for s in records:
        kids[s.parent].append(s)

    def registered(frame):
        return any(k.name == "atdn::keyframes.append"
                   for c in kids[frame.index] if c.name == "atdn::slam.keyframe" for k in kids[c.index])

    values = [sum(c.ms for c in kids[f.index] if c.name in names)
              for f in window if not keyframes_only or registered(f)]
    return statistics.median(values) if values else None

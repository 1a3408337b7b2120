"""95th percentile, over every frame of the window, of the host clock
from handing the frame to the runtime to its returned global pose."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.unit_s) * 1e3, 95))

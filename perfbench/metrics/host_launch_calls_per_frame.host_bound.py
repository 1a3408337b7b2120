"""CUDA launch calls the host made per frame of the traced slice (as
``host_launch_calls_per_frame.stream``)."""

from perfbench.core.spec import reader

read = reader("host_launch_calls_per_frame.stream")

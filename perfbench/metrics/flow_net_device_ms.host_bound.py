"""Device ms per frame of the kernels launched inside the flow net's
forward (as ``flow_net_device_ms.stream``)."""

from perfbench.core.spec import reader

read = reader("flow_net_device_ms.stream")

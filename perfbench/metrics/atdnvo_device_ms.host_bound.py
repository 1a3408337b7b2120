"""Device ms per frame of the kernels launched inside ATDNVO's forward (as
``atdnvo_device_ms.stream``)."""

from perfbench.core.spec import reader

read = reader("atdnvo_device_ms.stream")

"""``update_device_ms`` at KITTI (as ``update_device_ms.stream``)."""

from perfbench.core.spec import reader

read = reader("update_device_ms.stream")

"""``pose_wait_ms`` where the host sets the pace (KITTI)."""

from perfbench.core.spec import reader

read = reader("pose_wait_ms.stream")

"""``host_step_ms`` where the host sets the pace (KITTI): the median host
ms a window frame spends in the program's ``atdn::slam.flow`` and
``atdn::slam.odometry`` spans."""

from perfbench.core.spec import reader

read = reader("host_step_ms.stream")

"""K2's share of its roofline (as ``k2_roofline.stream``)."""

from perfbench.core.spec import reader

read = reader("k2_roofline.stream")

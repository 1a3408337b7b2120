"""``frame_ms_p95`` where the host sets the pace and its runs spread too widely
for a bound: the 95th percentile of the window's frames (host clock)."""

from perfbench.core.spec import reader

read = reader("frame_ms_p95")

"""``frames_per_s`` where the host sets the pace and its runs spread too widely
for a bound: frames of the window over its seconds (host clock)."""

from perfbench.core.spec import reader

read = reader("frames_per_s")

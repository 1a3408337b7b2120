"""The device's idle share over the slice recorded for the device alone (as
``device_idle_share.stream``)."""

from perfbench.core.spec import reader

read = reader("device_idle_share.stream")

"""1 - the union of the device operations' intervals over the traced
stretch's length (open loop): the closed loop's reader."""

from portbench import bench

read = bench.reader("device_idle_share.sat")

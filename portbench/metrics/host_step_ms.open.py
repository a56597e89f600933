"""Host time of the serving step, in ms (open loop): the closed loop's
reader."""

from portbench import bench

read = bench.reader("host_step_ms.sat")

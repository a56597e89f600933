"""Host time a step spent waiting on the card, in ms (open loop): the closed
loop's reader."""

from portbench import bench

read = bench.reader("sync_wait_ms.sat")

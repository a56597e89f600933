"""Sharding layer of the port (port of `repro.sharding`): the thread-local
mesh context (`ctx`) and the partition specs of parameters, optimizer
state, batches and caches with their per-device bytes (`specs`)."""

"""Training and serving steps of the port: the one-rank and explicit
data-parallel train steps, the fault-tolerant loop, the straggler monitor,
and the serving steps."""

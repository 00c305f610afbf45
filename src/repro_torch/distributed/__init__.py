"""Distributed layer of the port: the sharding rules and the SPMD
runtime of the model paths (``sharding``), lane-sharded batched SpGEMM
(``spgemm_shard``)."""

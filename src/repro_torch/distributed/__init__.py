"""Distributed layer of the port: lane-sharded batched SpGEMM
(``spgemm_shard``)."""

"""Distribution layer of the port: the device list of the sharded index
(``sharding.shard_mesh``)."""

"""Distribution layer of the port: the device list of the sharded index
and the logical-axis sharding of the models (``sharding``), the
collectives of the mesh code with their gradients (``tensor_parallel``),
and ``collectives`` and ``pipeline``."""

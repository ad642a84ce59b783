"""The parallel layer (port of dexbotic_tpu/parallel/): the launch contract
(``multihost``), the device mesh with FSDP2, tensor and expert parallelism
(``mesh``), context parallelism as a ring of K1 and K3 hops (``ring``) and
GPipe pipeline stages (``pipeline``)."""

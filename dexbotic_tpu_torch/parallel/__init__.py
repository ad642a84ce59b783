"""The parallel layer (port of dexbotic_tpu/parallel/): the launch contract
(``multihost``) and the device mesh with FSDP2 and tensor parallelism
(``mesh``).  Context parallelism (``ring``) and pipeline stages
(``pipeline``) are ROADMAP Queue 1 items 11b and 11c."""

"""The distributed layer of the port: the device mesh and its
collectives (``mesh``), and the one-round fetch, the sharded paged
decode, the expert-parallel MoE and the compressed gradient all-reduce
built on it."""

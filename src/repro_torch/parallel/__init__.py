"""The mesh, the sharding rules and the collectives of the port's explicit
SPMD (``parallel.sharding``)."""

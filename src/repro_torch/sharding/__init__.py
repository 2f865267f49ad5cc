"""Distribution: the sharding rules, the collectives over a mesh's process
groups, and the parallel context the models run under."""

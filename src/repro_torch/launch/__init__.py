"""Command-line launchers of the port, and the meshes of ranks
(:mod:`.mesh`) the sharded steps run on."""

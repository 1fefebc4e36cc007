"""The multi-device layer (counterparts of the reference's parallel/):
meshes and ordered collectives, the sharded build, the sharded frame and
path-trace step, and scene-memory sharding."""

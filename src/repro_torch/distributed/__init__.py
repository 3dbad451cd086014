"""The distributed layer: sharding rules (param, cache, input and optimizer
specs, DTensor placements, ``constrain``, the engine's field mesh) and
elastic rescale of a checkpoint onto another mesh."""

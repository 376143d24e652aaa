"""PLY export, camera orbits, scalar schedules and the flax -> torch weight
bridge."""

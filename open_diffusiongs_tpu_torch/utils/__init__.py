"""PLY export, camera orbits and the flax -> torch weight bridge."""

"""Bench entry points of the port (counterparts of the repo's tools/)."""

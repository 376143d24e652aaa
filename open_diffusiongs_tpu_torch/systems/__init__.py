"""Systems: the object system, its losses and its config builder."""

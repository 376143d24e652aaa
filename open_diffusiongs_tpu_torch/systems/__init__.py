"""Systems: the object system and its config builder."""

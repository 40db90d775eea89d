"""Small helpers shared by the GAME path."""

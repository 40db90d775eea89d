"""Small helpers shared by the GAME path and the drivers."""

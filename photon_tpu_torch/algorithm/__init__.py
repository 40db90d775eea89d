"""GAME coordinates and coordinate descent."""

"""GAME estimator, its configuration and transformer."""

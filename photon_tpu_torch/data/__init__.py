"""See the module docstrings; the layout mirrors photon_tpu."""

"""Command-line drivers (python -m photon_tpu_torch.cli.<driver>)."""

"""Down-sampling of the fixed-effect training data."""

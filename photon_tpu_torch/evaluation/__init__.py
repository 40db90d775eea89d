"""Validation metrics and the legacy driver's MetricsMap."""

"""Coefficients, GLMs and the GAME model container."""

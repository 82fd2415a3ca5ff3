"""Gradient-based attacks."""

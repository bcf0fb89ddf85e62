"""Fixture rolls and flat-npz parameter trees (numpy only)."""

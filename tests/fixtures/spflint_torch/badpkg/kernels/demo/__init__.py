"""Fixture kernel wrappers."""

"""Fixture kernel package."""

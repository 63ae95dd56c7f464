"""Bundled applications."""

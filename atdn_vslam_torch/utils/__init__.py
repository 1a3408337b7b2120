"""Helpers."""

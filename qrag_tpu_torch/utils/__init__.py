"""Metrics and logging helpers."""

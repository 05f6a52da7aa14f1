"""Tracing and serving metrics."""

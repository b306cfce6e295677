"""Tracing helpers."""

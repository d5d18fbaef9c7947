"""Tracing and profiling hooks."""

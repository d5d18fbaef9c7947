"""Billiards physics and in-memory test-corpus generation."""

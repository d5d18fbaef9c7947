"""Checkpoint bridge and evaluation."""

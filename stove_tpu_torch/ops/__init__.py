"""Ops: Gaussian algebra, slot matching, the fused CUDA rollout kernel."""

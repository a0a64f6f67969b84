"""Frozen operation and byte counts of the port's hand kernels, and the peaks."""

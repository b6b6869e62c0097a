"""Kinematic-tree utilities (numpy only)."""

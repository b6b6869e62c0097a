"""Port of apnerf/data (training rays, the synthetic scene)."""

"""Port of apnerf/utils."""

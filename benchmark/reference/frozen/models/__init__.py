"""Port of apnerf/models."""

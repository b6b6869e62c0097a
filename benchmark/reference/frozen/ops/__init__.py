"""Port of apnerf/ops."""

"""Port of apnerf/render."""

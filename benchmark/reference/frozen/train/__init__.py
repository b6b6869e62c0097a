"""Port of apnerf/train (stage 1)."""

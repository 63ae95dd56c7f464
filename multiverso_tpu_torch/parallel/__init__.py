"""Device context and partition math (reference L2 replacement)."""

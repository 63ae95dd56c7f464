"""The port's benchmark harness: the parts every cell shares."""

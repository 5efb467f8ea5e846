"""The chain step and the host streaming engine."""

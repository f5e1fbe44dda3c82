"""The port's benchmark: one command runs one cell once (see README.md)."""

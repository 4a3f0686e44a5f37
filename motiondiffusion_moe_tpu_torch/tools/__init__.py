"""Command-line and serving front ends."""

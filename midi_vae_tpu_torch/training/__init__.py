"""Run directories: config and parameters."""

"""Host utilities: the YAML config loader, checkpoints, the timing CSV,
profiler traces and the native sensor hub."""

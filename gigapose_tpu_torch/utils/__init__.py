"""Host utilities: logging, stage timers, the yaml-free config loader."""

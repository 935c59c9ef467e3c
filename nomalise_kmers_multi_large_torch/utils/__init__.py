"""Host utilities: the prefetch worker and the stage timer."""

"""Several devices (Modes A and B) and several host processes."""

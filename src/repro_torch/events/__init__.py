"""Event-camera data substrate: synthetic streams and chunk stacking."""

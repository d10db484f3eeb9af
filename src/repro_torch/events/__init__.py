"""Event-camera data substrate: synthetic streams, the AER codec, datasets
and chunk stacking (``synthetic``, ``aer``, ``datasets``, ``stream``;
import them directly, this package imports nothing eagerly)."""

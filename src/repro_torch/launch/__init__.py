"""Launch helpers (``repro.launch``): the pinned host stager of the pool's
uploads (``sharding.HostStager``)."""

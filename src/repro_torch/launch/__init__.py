"""Launch helpers (``repro.launch``): the meshes (``mesh``), the sharding
rules and the pool's host stager (``sharding``), the CLIs (``serve``,
``train``, ``serve_events``), and the dry-run and its roofline
(``dryrun``, ``roofline``)."""

"""Launchers of the port (twin of ``repro.launch``): ``train``, the
centralized training driver; ``steps``, the cells (a step, its arguments
and their sharding specs); ``roofline``, their counts and bounds;
``mesh``, the production and card meshes; ``dryrun``, the sweep of cells
on the production meshes (``meta`` traces) and on the card (executed)."""

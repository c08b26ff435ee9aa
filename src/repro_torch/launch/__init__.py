"""Launchers of the port (twin of ``repro.launch``): ``train``, the
centralized training driver. The reference's ``steps``, ``dryrun``,
``mesh`` and ``roofline`` belong to meshes and come with a later slice."""

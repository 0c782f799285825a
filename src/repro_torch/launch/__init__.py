"""Launchers of the port (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``), the dry run
(``python -m repro_torch.launch.dryrun``) with its meshes
(``launch.mesh``), and the assigned shapes and demo inputs
(``launch.shapes``)."""

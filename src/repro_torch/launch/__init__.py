"""Launchers (port of ``repro.launch``): the training driver, the
serving driver (``serve``) and the twin of ``examples/serve_cluster.py``
(``serve_cluster``).  The mesh, dry-run and roofline launchers arrive
with later slices."""

"""Launchers (port of ``repro.launch``): the production mesh, the
multi-pod dry run and the roofline analysis, the training loop
(``train``), the serving CLI (``serve``) and the twin of
``examples/serve_cluster.py`` (``serve_cluster``)."""

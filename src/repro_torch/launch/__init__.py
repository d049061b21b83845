"""Launchers (port of ``repro.launch``): the training driver.  The mesh,
dry-run, roofline and serving launchers arrive with later slices."""

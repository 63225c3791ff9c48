"""Launchers (``repro/launch``): the LM serving and training drivers, the
device meshes the models' mesh forms run on, the step builders of the
registry's (arch x shape) cells (``steps.py``), and the dry run that
counts each cell's per-device costs (``dryrun.py``, its op counter
``opcost.py``, ``roofline.py``)."""

"""Launchers (``repro/launch``): the LM serving and training drivers, the
device meshes the models' mesh forms run on, and the step builders of the
registry's (arch x shape) cells (``steps.py``)."""

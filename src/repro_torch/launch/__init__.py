"""Launchers (``repro/launch``): the LM serving and training drivers, and
the device meshes the models' mesh forms run on."""

"""Launchers: the LM serving driver (``repro/launch``)."""

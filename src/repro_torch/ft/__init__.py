"""Fault tolerance: elastic re-meshing, straggler mitigation
(``repro/ft``)."""

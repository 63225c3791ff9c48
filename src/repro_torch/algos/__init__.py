"""Pluggable coloring algorithms (``repro/algos``): the ``Algorithm``
protocol and registry. Registered: ``ipgc``, ``jpl``, ``spec-greedy``."""
from repro_torch.algos.base import (Algorithm, algorithm_names,  # noqa: F401
                                    get_algorithm, register)
from repro_torch.algos.ipgc_algo import IPGC
from repro_torch.algos.jpl import JPL
from repro_torch.algos.spec_greedy import SpecGreedy

register(IPGC())
register(JPL())
register(SpecGreedy())

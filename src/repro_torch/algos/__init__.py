"""Pluggable coloring algorithms (``repro/algos``): the ``Algorithm``
protocol and registry. Registered: ``ipgc``."""
from repro_torch.algos.base import (Algorithm, algorithm_names,  # noqa: F401
                                    get_algorithm, register)
from repro_torch.algos.ipgc_algo import IPGC

register(IPGC())

"""The benchmark of the PyTorch and CUDA port (``repro_torch``): the
harness (``run.py``), its yardstick (generators, plain reference, kernel
byte rules, trace reduction, table of peaks) and its tests."""

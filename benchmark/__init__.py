"""The benchmark of sphexa_torch, the PyTorch and CUDA port, on NVIDIA cards.

One run drives one cell (a configuration under a traffic mix) through the
port's ``Simulation.step()`` for a fixed number of seconds and prints one
JSON line of metrics; ``run.py`` is the entry point. Everything a cell
needs is found by name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``inits/<init>.py``, ``reference/<prop>.py``, ``limits/<config>.json`` and
``metrics/<metric>.py``. Only ``program.py`` imports the port; the
reference under ``reference/`` imports nothing of it.
"""

"""The plain reference: one SPH-EXA time step in plain PyTorch, in
float64 (or, for the control, in a lower precision), over explicit pair
lists. It imports nothing of the port, of JAX or of sphexa_tpu; it reads
the port's outputs only to judge them. ``<prop>.py`` holds a propagator's
step (``std.py``, ``ve.py``)."""

"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch path (model, losses, optimizer, statics, inference step and
metrics), with every hand-written kernel replaced by its plain version,
the topology built by the numpy builders, and data parallelism and
rematerialization reduced to their one-process identities
(``parallel.py``, ``remat.py``).  It imports nothing of the program, so
a change to the program cannot move it; ``steps.py`` drives it.
"""
